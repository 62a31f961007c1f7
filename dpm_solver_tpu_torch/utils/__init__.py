"""Helpers of the port: tensor broadcasting, the Flax -> torch weight bridge and the
checkpoint reader (`convert`), and the host utilities of the serving and data paths
(`ckpt_util`, `safety`, `watermark`, `degradation`)."""
