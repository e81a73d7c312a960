"""Scene/data layer: dataset loading, cameras, image and PLY I/O."""

from neuralgaussiansplatting_torch.scene.scene import Scene  # noqa: F401
from neuralgaussiansplatting_torch.scene.cameras import Camera, CameraInfo  # noqa: F401
