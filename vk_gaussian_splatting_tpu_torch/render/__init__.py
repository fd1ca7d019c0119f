from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    RenderOutput,
    render,
    render_3dgrt,
    render_3dgs,
    render_3dgut,
)

__all__ = ["RenderOutput", "render", "render_3dgrt", "render_3dgs", "render_3dgut"]
