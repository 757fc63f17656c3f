from ohm_tsd_slam_tpu_torch.core import cloud, se2

__all__ = ["cloud", "se2"]
