from ohm_tsd_slam_tpu_torch.core import se2

__all__ = ["se2"]
