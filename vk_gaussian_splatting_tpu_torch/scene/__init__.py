from vk_gaussian_splatting_tpu_torch.scene.splat_set import SplatSet, PreparedSplats
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera

__all__ = ["SplatSet", "PreparedSplats", "Camera"]
