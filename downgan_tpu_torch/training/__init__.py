from downgan_tpu_torch.training.state import (
    GANTrainState,
    load_generator,
    make_critic,
    make_generator,
    make_optimizer,
    make_train_state,
)

__all__ = ["GANTrainState", "load_generator", "make_critic", "make_generator",
           "make_optimizer", "make_train_state"]
