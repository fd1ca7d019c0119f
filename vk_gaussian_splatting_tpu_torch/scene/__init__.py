from vk_gaussian_splatting_tpu_torch.scene.splat_set import SplatSet, PreparedSplats
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera, CameraSet

__all__ = ["SplatSet", "PreparedSplats", "Camera", "CameraSet"]
