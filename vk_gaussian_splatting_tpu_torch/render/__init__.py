from vk_gaussian_splatting_tpu_torch.render.mesh_raster import (
    MeshBuffers,
    mesh_buffers_from_obj,
    render_mesh,
)
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    RenderOutput,
    render,
    render_3dgrt,
    render_3dgs,
    render_3dgs_composed,
    render_3dgut,
)

__all__ = ["MeshBuffers", "RenderOutput", "mesh_buffers_from_obj", "render", "render_3dgrt",
           "render_3dgs", "render_3dgs_composed", "render_3dgut", "render_mesh"]
