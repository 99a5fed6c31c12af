from downgan_tpu_torch.config.config import REGIONS, Config, HyperParams, RegionBox

__all__ = ["Config", "HyperParams", "REGIONS", "RegionBox"]
