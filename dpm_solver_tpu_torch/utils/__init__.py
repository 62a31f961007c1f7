"""Helpers of the port: tensor broadcasting, the Flax -> torch weight bridge and the
checkpoint reader (`convert`), and the host utilities of the serving and data paths
(`ckpt_util`, `safety`, `watermark`, `degradation`)."""

from dpm_solver_tpu_torch.utils.trees import bcast_right

__all__ = ["bcast_right"]
