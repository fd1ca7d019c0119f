from vk_gaussian_splatting_tpu_torch.parallel.sharded_render import (
    make_mesh,
    render_3dgrt_sharded,
    render_3dgs_sharded,
    render_3dgut_sharded,
    train_step_sharded,
)

__all__ = ["make_mesh", "render_3dgrt_sharded", "render_3dgs_sharded",
           "render_3dgut_sharded", "train_step_sharded"]
