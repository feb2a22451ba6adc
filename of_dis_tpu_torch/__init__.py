"""of_dis_tpu_torch — the PyTorch / CUDA port of of_dis_tpu (Dense Inverse
Search optical flow, Kroeger et al., ECCV 2016) for NVIDIA Hopper.

Plain tensor code is PyTorch; every TPU kernel of the JAX package is a
hand-written CUDA kernel (csrc/level_search.cu, csrc/gn_search.cu,
csrc/refine_inner.cu, csrc/sor_rb.cu) built with nvcc at first use
(ops/build.py).  Entry points run on CUDA unless given device="cpu", where
the kernels' plain PyTorch versions run instead.  On the card each entry
point runs its pair or batch as a CUDA graph, captured at the first call
for a static key (config, shapes, static arguments) and replayed after
(ops/graphs.py, the counterpart of jax.jit); `eager()` runs them op by op
(jax.disable_jit()).  Imports neither JAX nor of_dis_tpu.

Public API:
    dis_flow(img1, img2, cfg, device=None)   -> (H, W, 2) optical flow tensor
    dis_stereo(img1, img2, cfg, device=None) -> (H, W) disparity tensor (left camera <= 0)
    dis_raw(img1, img2, cfg, ...)            -> (H, W, nop) tensor
    batched_flow(imgs1, imgs2, cfg, device=None, mesh=None) -> (B, H, W, nop)
        tensor, one batched launch per kernel call for all B pairs; with a
        data mesh (data_mesh) each rank runs its share and gets the whole result
    parallel.video.process_video / process_video_batched: video with warm
        start and checkpoint / resume (the batched one also over a data mesh)
    spatial sharding over torch.distributed (one process per rank):
        init_distributed, data_mesh, mesh_2d, mesh_3d;
        spatial_flow (1-D column strips), spatial_flow_tiled (2-D tiles),
        flow_2d / flow_2d_tiled (a batch over data, each pair sharded)
    DISConfig, operating_point, auto_first_scale
    io.read_flo / write_flo / read_pfm / write_pfm / load_image
    viz.flow_to_color / disparity_to_gray / save_image
    utils.instrument.dis_flow_timed: dis_raw with the per-scale -v 2 table
    utils.eval: EPE and error statistics
    eager(): a context in which every executable runs op by op
"""

from .config import DISConfig, auto_first_scale, operating_point
from .models.dis import dis_flow, dis_raw, dis_stereo
from .ops.graphs import eager
from .parallel.batch import batched_flow, data_mesh
from .parallel.multihost import flow_2d, flow_2d_tiled, init_distributed, mesh_2d, mesh_3d
from .parallel.spatial import spatial_flow, spatial_flow_tiled
from . import io
from .utils import viz

__version__ = "0.1.0"

__all__ = [
    "DISConfig",
    "auto_first_scale",
    "batched_flow",
    "data_mesh",
    "flow_2d",
    "flow_2d_tiled",
    "init_distributed",
    "mesh_2d",
    "mesh_3d",
    "operating_point",
    "spatial_flow",
    "spatial_flow_tiled",
    "dis_flow",
    "dis_raw",
    "dis_stereo",
    "eager",
    "io",
    "viz",
]
