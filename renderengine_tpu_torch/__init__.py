"""renderengine_tpu_torch — the PyTorch/CUDA port of ``renderengine_tpu``.

The same software renderer (a rebuild of hugbed/RenderEngine's Vulkan
forward renderer as array programs), written in PyTorch for an NVIDIA
Hopper GPU. The layout mirrors the JAX package, so each module's
counterpart sits at the same path:

core     config, host math (glm/Vulkan-convention mat4 stack), AABB, CLI
         arguments, virtual asset paths, engine init.
scene    host-side scene state, texture atlas, procedural scenes, scene
         loaders (OBJ, glTF/GLB, Collada, binary FBX), input and the
         camera controller.
raster   triangle setup, tile binning, the brute-force raster oracle and
         the tile raster kernels (``csrc/raster_tile.cu``) with their
         plain PyTorch versions.
shading  sRGB, texture sampling, PBR (Filament BRDF), Blinn-Phong,
         shadows, skybox, light charts, IBL capture, grid and overlay quad.
graph    per-frame uniforms, the frame pipeline and its reactive runtime
         (``FrameRenderer``), the render loop (``RenderLoop``).
parallel the sharded renderer over ``torch.distributed`` (row bands of
         the frame, a triangle share of the shadow maps a rank).
apps     ``main_sample`` (frames to PNG), ``live_viewer`` (browser),
         ``editor`` and project files.
native   host asset-parsing helpers in C++ (PNG, OBJ, JPEG), via ctypes.
utils    PNG/EXR/image IO, HUD, logging, profiling.

The package imports torch and numpy, never JAX. Its entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
