"""PyTorch + CUDA port of the ovr_tpu volume renderer.

The package mirrors `ovr_tpu`'s layout (`core/`, `render/`, `ops/`, `io/`,
`native/`, `api.py`) and never imports JAX or `ovr_tpu`. Plain tensor code is
PyTorch; the fused shear-warp slice loop is a CUDA C++ kernel for Hopper
(`csrc/swslice.cu`), built with nvcc at first use.

Entry points run on the card unless the caller passes `device="cpu"`:

    from ovr_tpu_torch import api
    from ovr_tpu_torch.core.scene import simple_scene

    scene = simple_scene(grid)                       # tensors on "cuda"
    cfg = api.RenderConfig(width=1920, height=1080, method="auto",
                           shading="diffuse").resolved(scene)
    frame = api.render(scene, cfg)

Scene files (VIDI3D JSON, USDA settings) load with
`ovr_tpu_torch.io.create_scene(path, device=...)`; `RenderConfig(
path_tracing=True, pt_dense=False|True)` path-traces them.
"""
