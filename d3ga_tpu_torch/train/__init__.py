from d3ga_tpu_torch.train.losses import l1_loss, masked_psnr, psnr, ssim  # noqa: F401
from d3ga_tpu_torch.train.optim import make_optimizer, multistep_schedule  # noqa: F401
