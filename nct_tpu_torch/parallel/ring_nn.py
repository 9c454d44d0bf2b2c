"""Ring-scheduled exact NN search over row bands (counterpart of
``nct_tpu/parallel/ring_nn.py``).

The exact search (``ops/cuda_nn.py``) holds both whole patch tables; under
a space mesh that is a per-rank footprint that grows with the style image.
Here both images stay row-sharded over the mesh's ``space`` axis: rank r
holds its band of rows of each (``parallel.mesh.RowBand``; the pipeline's
bands follow ``mesh.image_bands``), builds the patch tables of its band's
pixels from those rows plus a halo of ``patch_size // 2`` rows from its
neighbours, and in each of the n steps searches its A band against the
resident B block with the directed kernel while the block moves one rank
down the ring (send to r-1, receive from r+1: JAX's ``ppermute`` with
``perm = [(j, (j-1) % n)]``), the transfer posted before the search so
that the two overlap.  Blocks are padded to the largest band's pixels; the
block visiting at step s is band (r+s) % n, whose first pixel's global
index the band rule gives every rank.  Per-rank matcher memory is
O(Nb/n), and ``ring_band_nn`` returns the rank's own band of the NNF.

The tables are the port's own (bf16 patch rows, ``exact_nn.prep_tables``),
so the ring searches what ``cuda_nn.exact_nn`` searches.  Tie rule: each
step's (distance, global index) is folded by the kernel's own 64-bit key
(``cuda_nn.encode_keys``: ordered distance, then index), so on equal
distances the earliest *global* index wins, whatever the visiting order,
and the result is ``exact_nn``'s bit for bit.  (The JAX ring keeps the
first-visited block on ties, which can differ for A rows on ranks > 0; its
test bounds that statistically.)

Transport: under nccl the blocks move as device tensors.  gloo moves host
memory only (a CUDA pointer handed to its point-to-point ops crashes), so
there the blocks of a card-resident ring are staged through pinned host
buffers; a CPU ring sends its tensors as they are.  On a CUDA tensor each
step launches ``cuda_nn.nn_directed_tables`` (``LAUNCHES["nn_directed"]``
counts it; with a batch axis one launch covers every item); on a CPU
tensor it runs the plain ``exact_nn.nn_tables_plain``.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.ops.exact_nn import nn_tables_plain, unpack_nnf
from nct_tpu_torch.ops.patchmatch import patch_offsets, patchify
from nct_tpu_torch.parallel.mesh import RowBand, image_bands, pad_to_multiple


# The kernel's keys are uint64s held in int64; flipping the top bit makes
# signed order the unsigned one
_SIGN = -2 ** 63


@dataclasses.dataclass
class RingTiming:
    """What ``ring_exact_nn(timing=...)`` records on a card: CUDA events
    around each step's search, and host seconds spent copying blocks to and
    from host memory (``staging_s``) and waiting for a rotation
    (``wait_s``)."""

    step_events: list = dataclasses.field(default_factory=list)
    staging_s: float = 0.0
    wait_s: float = 0.0

    def step_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.step_events]


def band_tables(x_norm: torch.Tensor, start: int, rows: int,
                patch_size: int):
    """Rows ``[start, start + rows)`` of ``exact_nn.prep_tables(x_norm)``,
    built from the feature rows they need: (F [..., rows, K*C] bf16, M
    [rows, K] 0/1 validity).  Rows past the image's last pixel are zero,
    with mask 0."""
    h, w, c = x_norm.shape[-3:]
    lead = tuple(x_norm.shape[:-3])
    k, half = len(patch_offsets(patch_size)), patch_size // 2
    end = min(start + rows, h * w)
    if end <= start:
        return (torch.zeros(lead + (rows, k * c), dtype=torch.bfloat16,
                            device=x_norm.device),
                torch.zeros((rows, k), device=x_norm.device))
    # the image rows of the band and the halo rows its taps read: patchify
    # of that slab is exact for the band, as each slab edge is a halo row
    # or the image's border.  bf16 before the 9-tap stack: rounding
    # commutes with the copies, and the stack is the band's largest buffer
    lo = max(start // w - half, 0)
    hi = min((end - 1) // w + patch_size - 1 - half, h - 1)
    p, pm = patchify(x_norm[..., lo:hi + 1, :, :].float().to(torch.bfloat16),
                     patch_size)
    n, o, tail = end - start, start - lo * w, start + rows - end
    f = p.reshape(lead + (-1, k * c))[..., o:o + n, :]
    m = pm.reshape(-1, k)[o:o + n].float()
    return F.pad(f, (0, 0, 0, tail)), F.pad(m, (0, 0, 0, tail))


def _operands(f: torch.Tensor, m: torch.Tensor):
    """A band's search operands on its device: the kernel's (KC padded to
    DEPTH, int32 bit masks) on a card, the plain version's (0/1 masks) on
    the CPU; masks carry the batch axis of ``f``."""
    lead = tuple(f.shape[:-2])
    if f.device.type == "cpu":
        return f, m.expand(lead + tuple(m.shape)).contiguous()
    if f.shape[-1] % cuda_nn.DEPTH:
        f = F.pad(f, (0, -f.shape[-1] % cuda_nn.DEPTH))
    bits = cuda_nn.mask_bits(m)
    return f.contiguous(), bits.expand(lead + tuple(bits.shape)).contiguous()


def _search(fa, ma, fb, mb):
    if fa.device.type == "cpu":
        return nn_tables_plain(fa, ma, fb, mb)
    return cuda_nn.nn_directed_tables(fa, ma, fb, mb)


class _Ring:
    """Moves the resident block one rank down the ring per step: device
    tensors directly, or (``staged``) a card's blocks through pinned host
    buffers for gloo."""

    def __init__(self, mesh, axis: str, block, timing):
        ranks = mesh.ranks(axis)
        me = mesh.index(axis)
        n = len(ranks)
        self.to, self.frm = ranks[(me - 1) % n], ranks[(me + 1) % n]
        self.group = mesh.group(axis)
        self.staged = mesh.backend == "gloo" and block[0].device.type == "cuda"
        self.timing = timing
        self.dev = list(block)
        if self.staged:
            t0 = time.perf_counter()
            self.host, self.host_next = (
                [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in block] for _ in range(2))
            for h, t in zip(self.host, block):
                h.copy_(t)
            self.dev_next = [torch.empty_like(t) for t in block]
            # events after the last two host-to-card copies: the one before
            # the last read the buffers the next rotation receives into
            self.landed = self.landed_before = None
            self._staging(t0)

    def _staging(self, t0: float) -> None:
        if self.timing is not None:
            self.timing.staging_s += time.perf_counter() - t0

    def post(self):
        """Start sending the resident block and receiving the next one."""
        if self.staged:
            if self.landed_before is not None:
                t0 = time.perf_counter()
                self.landed_before.synchronize()
                self._staging(t0)
            send, self.recv = self.host, self.host_next
        else:
            send, self.recv = self.dev, [torch.empty_like(t) for t in self.dev]
        ops = [dist.P2POp(dist.isend, t, self.to, self.group, tag)
               for tag, t in enumerate(send)]
        ops += [dist.P2POp(dist.irecv, t, self.frm, self.group, tag)
                for tag, t in enumerate(self.recv)]
        self.works = dist.batch_isend_irecv(ops)

    def swap(self):
        """Wait for the rotation; the received block becomes resident."""
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        if self.timing is not None:
            self.timing.wait_s += time.perf_counter() - t0
        if not self.staged:
            self.dev = self.recv
            return
        # the copies queue behind this step's search on the stream, so the
        # host goes on; the next post waits for them before reusing buffers
        for d, h in zip(self.dev_next, self.recv):
            d.copy_(h, non_blocking=True)
        self.landed_before, self.landed = self.landed, torch.cuda.Event()
        self.landed.record()
        self.dev, self.dev_next = self.dev_next, self.dev
        self.host, self.host_next = self.host_next, self.host


def _band_operands(ext: torch.Tensor, top: int, rows: int, padded: int,
                   patch_size: int):
    """The search operands of a band's ``rows`` image rows held in
    ``ext`` below ``top`` halo rows, padded with masked-out rows to
    ``padded`` table rows."""
    w = ext.shape[-2]
    f, m = band_tables(ext, top * w, rows * w, patch_size)
    tail = padded - rows * w
    return _operands(F.pad(f, (0, 0, 0, tail)), F.pad(m, (0, 0, 0, tail)))


def ring_band_nn(a_band: torch.Tensor, b_band: torch.Tensor,
                 band_a: RowBand, band_b: RowBand, patch_size: int = 3,
                 timing: RingTiming | None = None):
    """Exhaustive NN a -> b over row bands: every rank of the bands' axis
    calls it with its own rows of a_norm [..., rows_a, Wa, C] and b_norm
    [..., rows_b, Wb, C] (L2-normalized; an optional leading batch axis on
    both) and gets its band of the result: (nnf [..., rows_a, Wa, 2] int32
    global (x, y), annd [..., rows_a, Wa] f32), earliest global index on
    ties.  A band of zero rows on either side searches nothing at the
    steps it takes part in (no launch), yet passes every block on.
    ``timing`` collects the steps' CUDA events and the host's staging and
    waiting time."""
    if a_band.device != b_band.device:
        raise ValueError("a_norm and b_norm must be on one device")
    half = patch_size // 2
    n, r = band_b.n, band_b.r
    wa, wb = a_band.shape[-2], b_band.shape[-2]
    lead = tuple(a_band.shape[:-3])
    a_ext, top_a, _ = band_a.halo(a_band, half, half)
    b_ext, top_b, _ = band_b.halo(b_band, half, half)
    first = [band_b.span(j)[0] * wb for j in range(n)]
    nb_loc = pad_to_multiple(max((band_b.span(j)[1] - band_b.span(j)[0])
                                 * wb for j in range(n)), cuda_nn.TILE)
    na = band_a.rows * wa
    fa, ma = _band_operands(a_ext, top_a, band_a.rows,
                            pad_to_multiple(na, cuda_nn.TILE), patch_size)
    block = _band_operands(b_ext, top_b, band_b.rows, nb_loc, patch_size)
    del a_ext, b_ext
    ring = _Ring(band_b.mesh, band_b.axis, block, timing) if n > 1 else None
    best = None
    for s in range(n):
        last = s == n - 1
        if not last:
            ring.post()
        j = (r + s) % n
        # an empty A band or visiting block has nothing to search: the
        # step only passes the block on
        if na and band_b.holds(j):
            cuda = timing is not None and fa.device.type == "cuda"
            if cuda:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            d, i = _search(fa, ma, *(ring.dev if ring else block))
            if cuda:
                events[1].record()
                timing.step_events.append(events)
            keys = cuda_nn.encode_keys(d, i + first[j]) ^ _SIGN
            best = keys if best is None else torch.minimum(best, keys)
        if not last:
            ring.swap()
    if best is None:
        best = torch.zeros(lead + (0,), dtype=torch.int64, device=fa.device)
    d, i = cuda_nn.decode_keys((best ^ _SIGN)[..., :na])
    return (unpack_nnf(i, band_b.h * wb, band_a.rows, wa, wb),
            d.reshape(lead + (band_a.rows, wa)))


def ring_exact_nn(a_norm: torch.Tensor, b_norm: torch.Tensor, mesh,
                  axis: str = "space", patch_size: int = 3,
                  timing: RingTiming | None = None):
    """``ring_band_nn`` on whole features: every rank of ``axis`` calls it
    with the same a_norm [..., Ha, Wa, C] / b_norm [..., Hb, Wb, C], takes
    its band of rows of each (``image_bands`` with one-row units: with
    fewer rows than ranks the trailing ranks hold none) and gets
    the whole result, the bands gathered: the contract of
    ``cuda_nn.exact_nn`` (nnf [..., Ha, Wa, 2] int32, annd [..., Ha, Wa]
    f32), earliest global index on ties."""
    n = mesh.shape[axis]
    bands = []
    for x in (a_norm, b_norm):
        h = x.shape[-3]
        bands.append(RowBand(mesh, axis, tuple(image_bands(h, n, 1)[:-1]), h))
    nnf, d = ring_band_nn(bands[0].take(a_norm), bands[1].take(b_norm),
                          *bands, patch_size, timing)
    return bands[0].gather(nnf), bands[0].gather(d, -2)
