from dpm_solver_tpu_torch.models.ddpm_unet import DDPMUNet, DDPMUNetConfig, init_random_

__all__ = ["DDPMUNet", "DDPMUNetConfig", "init_random_"]
