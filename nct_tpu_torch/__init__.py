"""nct_tpu_torch — Neural Color Transfer on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the JAX package ``nct_tpu``, which stays beside it as
the reference the port is tested against.  The layout mirrors the JAX
package so each counterpart is easy to find:

  nct_tpu_torch.config    -- hyper-parameters (fields of nct_tpu.config)
  nct_tpu_torch.ops       -- colour, resize, exact patch NN search (CUDA
                             kernel in ops/cuda_nn.py), PatchMatch, window
                             refine, BDS vote
  nct_tpu_torch.models    -- VGG-19 feature extractor (nn.Module), the
                             caffemodel reader
  nct_tpu_torch.solve     -- k-means, k-NN graph, PCG solvers
  nct_tpu_torch.data      -- PNG codec, prefetching PairLoader
  nct_tpu_torch.parallel  -- geometry buckets, batch transfer (scan, vmap,
                             over a mesh), the torch.distributed mesh and
                             the ring-scheduled exact matcher
  nct_tpu_torch.pipeline  -- the 5-level progressive ``transfer_pair`` and
                             the video path ``transfer_sequence``
  nct_tpu_torch.cli       -- pairs.txt batch CLI (python -m nct_tpu_torch.cli)
  nct_tpu_torch.utils     -- stage timing and profiler hooks, FLOP counts,
                             SSIM, visualisations, glog
  nct_tpu_torch.tools     -- per-stage profiler (python -m
                             nct_tpu_torch.tools.profile_stages), the
                             caffemodel converter (tools.convert_vgg19)
  nct_tpu_torch.csrc      -- CUDA C++ sources, built with nvcc at first use

Public functions keep the JAX package's layouts: images [H, W, 3] uint8
BGR, features [H, W, C], NNFs [H, W, 2] int32 in (x, y) order.
"""

__version__ = "0.1.0"

from nct_tpu_torch.config import Config  # noqa: F401
