from vk_gaussian_splatting_tpu_torch.render.deferred import DeferredMaterial
from vk_gaussian_splatting_tpu_torch.render.helpers import (
    render_gizmo_overlay,
    render_grid_overlay,
)
from vk_gaussian_splatting_tpu_torch.render.mesh_raster import (
    MeshBuffers,
    mesh_buffers_from_obj,
    render_mesh,
)
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    RenderOutput,
    render,
    render_3dgrt,
    render_3dgrt_exact,
    render_3dgs,
    render_3dgs_composed,
    render_3dgs_lit,
    render_3dgut,
    render_composed_wavefront,
    render_hybrid,
)
from vk_gaussian_splatting_tpu_torch.render.shadows import make_ray_shadow_fn, make_shadow_fn

__all__ = ["DeferredMaterial", "MeshBuffers", "RenderOutput", "make_ray_shadow_fn",
           "make_shadow_fn", "mesh_buffers_from_obj", "render", "render_3dgrt",
           "render_3dgrt_exact", "render_3dgs", "render_3dgs_composed", "render_3dgs_lit",
           "render_3dgut", "render_composed_wavefront", "render_gizmo_overlay",
           "render_grid_overlay", "render_hybrid", "render_mesh"]
