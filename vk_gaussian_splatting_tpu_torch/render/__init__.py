from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    RenderOutput,
    render,
    render_3dgs,
)

__all__ = ["RenderOutput", "render", "render_3dgs"]
