from downgan_tpu_torch.training.state import load_generator, make_generator

__all__ = ["load_generator", "make_generator"]
