"""Mesh-sharded emulated GEMM over torch.distributed ranks.

Counterpart of `gemmul8_tpu/parallel/distributed.py`. The ranks form a
2-D mesh ('x', 'y'), one card a rank (NCCL; gloo for CPU tensors). Each
rank holds its own shards and returns its own tile:

  A (m, k)  -> P('x', 'y')   block (m/nx, k/ny) at rank (x, y)
  B (k, n)  -> P('y', 'x')   block (k/ny, n/nx)
  C (m, n)  -> P('x', 'y')   tile (m/nx, n/ny)

A step: B's blocks are all-gathered over x into the rank's full-n slab
(k/ny, n); the shift statistics are merged over y, the k-sharded axis, so
that every rank picks the same globally valid shift (fast mode: the max
exponent, the norms rescaled to it by exact powers of two and summed in
rank order, the finite flags or-ed; accurate mode: the max exponent, then
the int32 magnitude product summed over y before its row maxima, its
column maxima max-reduced over x); each rank encodes its shards into int8
residue slices and multiplies them mod each modulus on its card, into
canonical uint8 residues of its k-partial products; an all-to-all over y
sends column block j of those residues to rank (x, j), which sums the ny
blocks in int32 and reconstructs its tile.

The scatter is exact: the residues of a sum are congruent to the sum of
the partials' residues, and the int32 sum of at most ny canonical bytes
stays far inside int32 (the bound on the products is on the global k, k <=
2^17, checked at entry). It gives the bits of the JAX package's int32
`psum_scatter` of the products while moving one byte an element, not four.

On the card each rank runs the hand-written kernels: `fast_stats`
(fast_sft's statistics mode), `encode_slices`, `matmul_mod_u8` or
`matmul_complex_mod`, `reconstruct`, and in accurate mode `emax` and
`mag7`. The accurate magnitude product must be summed over y before its
maxima are taken, so it is not `magmax_matmul` (which never stores the
product) but one int8 product on the card (`torch._int_mm`), as the JAX
package forms it outside any Pallas kernel. CPU tensors run the plain
versions, as everywhere in the port.

A shard must lie on the mesh's device (`make_mesh(device=)`: the rank's
card on NCCL, the CPU on gloo unless the mesh names a card, whose
tensors gloo then moves through host memory): a CUDA shard on a CPU gloo
mesh, a CPU shard on an NCCL mesh, or a shard on another card raises
before any collective; nothing is moved to another device or backend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .. import tables
from ..api import _complex_out_kind, _out_kind
from ..core import complexgemm as cg
from ..core import encode as enc
from ..core import slicegemm as sg
from ..hopper import kernels as hk
from ..hopper import matmul as hm
from ..types import ComputeType

@dataclass(frozen=True)
class Mesh:
    """This rank's place in an nx x ny mesh of the default process group:
    rank r sits at (r // ny, r % ny), the row-major layout of
    `jax.make_mesh`. `over_y` is the group of the ranks in this rank's x
    row (the collectives over y), `over_x` that of its y column."""

    nx: int
    ny: int
    rank: int
    backend: str
    device: torch.device
    over_x: object
    over_y: object

    @property
    def x(self) -> int:
        return self.rank // self.ny

    @property
    def y(self) -> int:
        return self.rank % self.ny

    @property
    def shape(self) -> dict:
        return {"x": self.nx, "y": self.ny}


def make_mesh(n_ranks: Optional[int] = None, shape=None,
              device=None) -> Mesh:
    """The mesh of every rank of the default process group. With no shape,
    n ranks are factored as close to square as possible (x = floor(sqrt
    n), stepped down to a divisor of n), as the JAX function does. Every
    rank must call it, with the same arguments: the axis groups are
    created in one order on every rank.

    device: the device of the shards the rank's group moves. By default
    the rank's card on NCCL and the CPU on gloo. A gloo mesh may name a
    card, whose tensors gloo then moves through host memory: several
    ranks can share one card that way, where NCCL needs a card a rank."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost."
                           "initialize_from_env() or init_process_group "
                           "first")
    world = dist.get_world_size()
    if shape is not None:
        n_ranks = shape[0] * shape[1]
    n = n_ranks or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: every "
                         "rank owns one mesh position")
    if shape is None:
        x = int(math.isqrt(n))
        while n % x:
            x -= 1
        shape = (x, n // x)
    nx, ny = shape
    backend = dist.get_backend()
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the engine runs on nccl "
                         "(CUDA tensors) or gloo (CPU tensors)")
    device = mesh_device(backend, device)
    rank = dist.get_rank()
    over_y = [dist.new_group([x * ny + j for j in range(ny)])
              for x in range(nx)]
    over_x = [dist.new_group([i * ny + y for i in range(nx)])
              for y in range(ny)]
    return Mesh(nx, ny, rank, backend, device, over_x[rank % ny],
                over_y[rank // ny])


def mesh_device(backend: str, device=None) -> torch.device:
    """The device of a mesh's shards: by default the current card on
    NCCL and the CPU on gloo; an NCCL mesh that names another kind
    raises."""
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an nccl mesh moves CUDA tensors, not {device}")
    return device


def check_device(mesh: Mesh, device: torch.device) -> None:
    """Raise unless a shard on `device` lies on the mesh's device, the one
    this rank's group moves tensors on."""
    if torch.device(device) != mesh.device:
        raise ValueError(f"a shard lies on {device}, but this rank's "
                         f"{mesh.backend} mesh moves tensors on "
                         f"{mesh.device}: nothing is moved to another device "
                         "or backend")


def shard_of(x, mesh: Mesh, spec=("x", "y")) -> torch.Tensor:
    """This rank's block of a global 2-D array (tensor or numpy) under
    spec: ("x", "y") cuts rows over x and columns over y (A and C), ("y",
    "x") rows over y and columns over x (B). A contiguous copy on the
    rank's device."""
    t = torch.as_tensor(x)
    parts = {"x": (mesh.nx, mesh.x), "y": (mesh.ny, mesh.y)}
    if t.dim() != 2 or sorted(spec) != ["x", "y"]:
        raise ValueError(f"a 2-D array and a spec of 'x' and 'y', not {spec}")
    (pr, ir), (pc, ic) = parts[spec[0]], parts[spec[1]]
    r, c = t.shape
    if r % pr or c % pc:
        raise ValueError(f"shape ({r}, {c}) must divide mesh "
                         f"{mesh.nx}x{mesh.ny} along {tuple(spec)}")
    br, bc = r // pr, c // pc
    return t[ir * br:(ir + 1) * br, ic * bc:(ic + 1) * bc].contiguous().to(
        mesh.device)


def assemble(tiles, mesh) -> torch.Tensor:
    """The global (m, n) array from every rank's P('x', 'y') tile, listed
    by rank. mesh: a Mesh or its (nx, ny) shape."""
    nx, ny = (mesh.nx, mesh.ny) if isinstance(mesh, Mesh) else mesh
    if len(tiles) != nx * ny:
        raise ValueError(f"{len(tiles)} tiles for a {nx}x{ny} mesh")
    ts = [torch.as_tensor(t) for t in tiles]
    return torch.cat([torch.cat(ts[x * ny:(x + 1) * ny], dim=1)
                      for x in range(nx)], dim=0)


# ---------------------------------------------------------------------------
# Collectives (every rank of a group calls each one in the same order)
# ---------------------------------------------------------------------------

def _all_gather(out, inp, group) -> None:
    """Every rank's inp, by group rank, into out (their concatenation on
    dim 0): torch's all_gather_single where it has it (its newer name),
    else all_gather_into_tensor."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _gather_b(parts, mesh: Mesh) -> torch.Tensor:
    """(P, k/ny, n/nx) blocks (P real parts of B) -> (P, k/ny, n): the
    rank's full-n slab, all-gathered over x (block i -> columns i n/nx)."""
    p, kl, nl = parts.shape
    out = torch.empty((mesh.nx * p, kl, nl), dtype=parts.dtype,
                      device=parts.device)
    _all_gather(out, parts.contiguous(), group=mesh.over_x)
    return out.view(mesh.nx, p, kl, nl).permute(1, 2, 0, 3).reshape(
        p, kl, mesh.nx * nl)


def _merge_over_y(stats, mesh: Mesh):
    """Fast-mode statistics (emax, nrm2, anyfinite) of the rank's k-slab
    -> those of the global k: the max exponent, each rank's norm rescaled
    to it by an exact power of two (`torch.ldexp`) and the norms summed in
    rank order from 0, the flags or-ed. One all-gather over y of the three
    packed as int64 (the norm by its f32 bits)."""
    emax, nrm2, af = stats
    shape = emax.shape
    packed = torch.stack([emax.reshape(-1).to(torch.int64),
                          nrm2.reshape(-1).view(torch.int32).to(torch.int64),
                          af.reshape(-1).to(torch.int64)])
    got = torch.empty((mesh.ny * 3, packed.shape[1]), dtype=torch.int64,
                      device=packed.device)
    _all_gather(got, packed, group=mesh.over_y)
    got = got.view(mesh.ny, 3, -1)
    e = got[:, 0]
    s = got[:, 1].to(torch.int32).view(torch.float32)
    emax_g = e.amax(dim=0)
    total = torch.zeros_like(s[0])
    for j in range(mesh.ny):
        total = total + rescale_norm(s[j], e[j] - emax_g)
    return (emax_g.reshape(shape), total.reshape(shape),
            (got[:, 2] != 0).any(dim=0).reshape(shape))


def rescale_norm(nrm2: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """nrm2 * 2^(2 d) for integer d <= 0: a squared norm relative to
    2^e moved to 2^(e - d), exact wherever the result is a normal f32
    (ROADMAP C13: the JAX package's `combine_stats` takes the power by
    `jnp.exp2` of a float)."""
    return torch.ldexp(nrm2, (2 * d).to(torch.int32))


def _fast_sft(stats, mesh: Mesh, k_total: int, num_moduli: int,
              mant_bits: int) -> torch.Tensor:
    emax, nrm2, af = _merge_over_y(stats, mesh)
    return enc.sft_from_stats(emax, nrm2, af, k_total, num_moduli, mant_bits)


def _scatter_reconstruct(r, sft_a, sft_b, num_moduli: int, kind: str,
                         mesh: Mesh) -> torch.Tensor:
    """(L, rows, ny w) canonical uint8 residues of the rank's k-partial
    products -> its (rows, w) tile: column block j goes to rank (x, j) by
    one all-to-all over y; the ny blocks received are summed in int32 (a
    lone block is used as it is) and reconstructed with the y-th block of
    the column shifts."""
    L, rows, cols = r.shape
    w = cols // mesh.ny
    send = r.reshape(L, rows, mesh.ny, w).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.over_y)
    res = recv[0] if mesh.ny == 1 else recv.sum(dim=0, dtype=torch.int32)
    sft_b = sft_b[:, mesh.y * w:(mesh.y + 1) * w].contiguous()
    return hk.reconstruct(res, sft_a, sft_b, num_moduli, kind)


def _mag_product(mag_a: torch.Tensor, mag_b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) int8 magnitudes -> their (m, n) int32 product, exact
    (every sum is at most 64 * 64 * 2^17 = 2^29). On the card one
    `torch._int_mm` (rows padded to more than 16, k and n to multiples of
    8, B column-major); on the CPU an f64 product."""
    m, k = mag_a.shape
    n = mag_b.shape[1]
    if mag_a.device.type == "cpu":
        return (mag_a.double() @ mag_b.double()).to(torch.int32)
    mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    a = mag_a.new_zeros((mp, kp))
    a[:m, :k] = mag_a
    bt = mag_b.new_zeros((np_, kp))
    bt[:n, :k] = mag_b.t()
    return torch._int_mm(a, bt.t())[:m, :n].contiguous()


def _accurate_sfts(a, b_full, num_moduli: int, mesh: Mesh):
    """Accurate-mode shifts with the contraction axis sharded over y: the
    max exponents max-reduced over y before the magnitudes are taken, the
    magnitude product summed over y in int32, its row maxima local and its
    column maxima max-reduced over x (all exact: the JAX package's
    `_accurate_sfts_sharded`)."""
    e_a, e_b = hk.emax(a, axis=1), hk.emax(b_full, axis=0)
    dist.all_reduce(e_a, op=dist.ReduceOp.MAX, group=mesh.over_y)
    dist.all_reduce(e_b, op=dist.ReduceOp.MAX, group=mesh.over_y)
    s = _mag_product(hk.mag7(a, e_a, axis=1), hk.mag7(b_full, e_b, axis=0))
    dist.all_reduce(s, group=mesh.over_y)
    smax_a = s.amax(dim=1, keepdim=True)
    smax_b = s.amax(dim=0, keepdim=True)
    dist.all_reduce(smax_b, op=dist.ReduceOp.MAX, group=mesh.over_x)
    return (enc.accurate_sft(smax_a, e_a, num_moduli,
                             mant_bits=enc.mant_bits_of(a)),
            enc.accurate_sft(smax_b, e_b, num_moduli,
                             mant_bits=enc.mant_bits_of(b_full)))


def _strided_panel(x: torch.Tensor, s: int, w: int, ny: int) -> torch.Tensor:
    """Panel s of the n axis as the union of every y block's s-th w-wide
    sub-block (global columns j n/ny + [s w, (s + 1) w) for each j): after
    the all-to-all rank (x, j) receives exactly its own columns, so the
    panels side by side are the one-shot tile."""
    kl, n = x.shape
    return x.reshape(kl, ny, n // ny)[:, :, s * w:(s + 1) * w].reshape(
        kl, ny * w)


def _global_shape(a_shape, b_shape, mesh: Mesh):
    (ml, kl), (kl2, nl) = a_shape, b_shape
    if kl != kl2:
        raise ValueError(f"inner dims mismatch: {tuple(a_shape)} x "
                         f"{tuple(b_shape)}")
    m, k, n = ml * mesh.nx, kl * mesh.ny, nl * mesh.nx
    if n % mesh.ny:
        raise ValueError(f"shapes ({m},{k},{n}) must divide mesh "
                         f"{mesh.nx}x{mesh.ny}")
    return m, k, n


def gemm_sharded(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                 num_moduli: int = 14, out_dtype=None,
                 fastmode: bool = True,
                 n_panel: Optional[int] = None) -> torch.Tensor:
    """Emulated GEMM 2-D sharded over `mesh`: this rank's tile (m/nx, n/ny)
    of C = A @ B from its shards a (m/nx, k/ny) of A and b (k/ny, n/nx) of
    B, float64 or float32 each (encoded at its own word), on the rank's
    device. Every rank of the mesh calls it with its own shards. The
    global shape must give n divisible by ny (and k <= 2^17). out_dtype as
    `gemm`'s (default float64 if either operand is float64).
    fastmode=False runs the accurate shift selection. n_panel (fast mode)
    encodes, multiplies and scatters B n_panel global columns at a time
    (n_panel / ny of each tile), with the one-shot call's bits."""
    for x in (a, b):
        check_device(mesh, x.device)
        enc.mant_bits_of(x)
    if not 2 <= num_moduli <= tables.MAX_MODULI:
        raise ValueError(f"num_moduli must be in [2, {tables.MAX_MODULI}]")
    _, k, n = _global_shape(a.shape, b.shape, mesh)
    if k > tables.MAX_K:
        raise ValueError("global k exceeds 2^17 int32-exactness bound")
    kind = _out_kind(a, b, out_dtype)
    if n_panel is not None:
        if not fastmode:
            raise NotImplementedError("n_panel requires fastmode")
        if n_panel < mesh.ny or n_panel % mesh.ny or \
                (n // mesh.ny) % (n_panel // mesh.ny):
            raise ValueError(
                f"n_panel={n_panel} must divide as n_panel/ny | n/ny")
    a = a.contiguous()
    b_full = _gather_b(b[None], mesh)[0]
    L = num_moduli
    if not fastmode:
        sft_a, sft_b = _accurate_sfts(a, b_full, L, mesh)
        a8 = hk.encode_slices(a, sft_a, L, axis=1)
        b8 = hk.encode_slices(b_full, sft_b, L, axis=0, k_major=True)
        r = hm.matmul_mod_u8(a8, b8, L)
        del a8, b8
        return _scatter_reconstruct(r, sft_a, sft_b, L, kind, mesh)
    sft_a = _fast_sft(hk.fast_stats(a, axis=1), mesh, k, L,
                      enc.mant_bits_of(a))
    a8 = hk.encode_slices(a, sft_a, L, axis=1)

    def tile_of(bp):
        """The tile's columns of B's (k/ny, ny w) panel bp."""
        sft_b = _fast_sft(hk.fast_stats(bp, axis=0), mesh, k, L,
                          enc.mant_bits_of(bp))
        r = hm.matmul_mod_u8(
            a8, hk.encode_slices(bp, sft_b, L, axis=0, k_major=True), L)
        return _scatter_reconstruct(r, sft_a, sft_b, L, kind, mesh)

    if n_panel is None:
        return tile_of(b_full)
    w = n_panel // mesh.ny
    out = torch.empty((a.shape[0], n // mesh.ny), device=a.device,
                      dtype=torch.float64 if kind == "f64" else torch.float32)
    for s in range(n // n_panel):
        out[:, s * w:(s + 1) * w] = tile_of(
            _strided_panel(b_full, s, w, mesh.ny))
    return out


def gemm_sharded_complex(a, b, mesh: Mesh, num_moduli: int = 14,
                         out_dtype=None, compute_type=None) -> torch.Tensor:
    """Complex emulated GEMM sharded over `mesh` (fast mode): this rank's
    complex tile (m/nx, n/ny) from its shards, laid out as `gemm_sharded`'s.
    a and b are complex or real tensors; each operand is encoded at its
    own word (complex128 and float64 in f64, complex64 and other real
    dtypes in f32), and the result is complex128 if either is, else
    complex64, or by out_dtype (`gemm`'s complex spellings).

    compute_type picks the strategy (default, and REAL_DEFAULT, the
    big-matrix form), each with the JAX package's residues: the block
    matrix [[Re, -Im], [Im, Re]] of A's slices times [Re; Im] of B's
    through `matmul_mod_u8`, or RR - II and IR + RI (classic) or the
    Karatsuba form through `matmul_complex_mod`. The Re and Im residues
    stacked by rows go through one all-to-all and one reconstruct."""
    if compute_type in (None, ComputeType.REAL_DEFAULT):
        compute_type = ComputeType.COMPLEX_BIG_MATRIX_ENCODE
    if compute_type not in cg._KMAX:
        raise ValueError(compute_type)
    a_re, a_im = cg.canon_complex(a)
    b_re, b_im = cg.canon_complex(b)
    kind_a, kind_b = cg.complex_kind(a), cg.complex_kind(b)
    for x in (a_re, b_re):
        check_device(mesh, x.device)
    if not 2 <= num_moduli <= tables.MAX_MODULI:
        raise ValueError(f"num_moduli must be in [2, {tables.MAX_MODULI}]")
    _, k, n = _global_shape(a_re.shape, b_re.shape, mesh)
    if k > cg._KMAX[compute_type]:
        raise ValueError(
            f"k={k} exceeds the int32-exactness bound for {compute_type}")
    kind = "f64" if _complex_out_kind((kind_a, kind_b),
                                      out_dtype) == "c128" else "f32"
    L = num_moduli
    b_parts = _gather_b(torch.stack([b_re, b_im]), mesh)
    br, bi = b_parts[0], b_parts[1]

    def joint_sft(re, im, axis):
        stats = enc.merge_stats(hk.fast_stats(re, axis),
                                hk.fast_stats(im, axis))
        return _fast_sft(stats, mesh, 2 * k, L, enc.mant_bits_of(re))

    sft_a = joint_sft(a_re, a_im, 1)
    sft_b = joint_sft(br, bi, 0)
    big = compute_type == ComputeType.COMPLEX_BIG_MATRIX_ENCODE
    a8r = hk.encode_slices(a_re, sft_a, L, axis=1)
    a8i = hk.encode_slices(a_im, sft_a, L, axis=1)
    # B's parts K-major for matmul_complex_mod; N-major where they are
    # stacked along k into the big matrix's B
    b8r = hk.encode_slices(br, sft_b, L, axis=0, k_major=not big)
    b8i = hk.encode_slices(bi, sft_b, L, axis=0, k_major=not big)
    if big:
        neg_a8i = (-a8i.to(torch.int32)).to(torch.int8)
        a_blk = torch.cat([torch.cat([a8r, neg_a8i], dim=2),
                           torch.cat([a8i, a8r], dim=2)], dim=1)
        b_blk = torch.cat([b8r, b8i], dim=1)
        del a8r, a8i, b8r, b8i, neg_a8i
        r = hm.matmul_mod_u8(a_blk, b_blk, L)     # (L, 2 m/nx, n)
        del a_blk, b_blk
    else:
        kara = None
        if compute_type == ComputeType.COMPLEX_KARATSUBA_MULT:
            kara = (sg.recenter_add_int8(a8r, a8i, L),
                    sg.recenter_add_int8(b8r, b8i, L))
        r_re, r_im = hm.matmul_complex_mod(a8r, a8i, b8r, b8i, L, kara=kara)
        del a8r, a8i, b8r, b8i, kara
        r = torch.cat([r_re, r_im], dim=1)
        del r_re, r_im
    out = _scatter_reconstruct(r, torch.cat([sft_a, sft_a], dim=0), sft_b,
                               L, kind, mesh)
    ml = a_re.shape[0]
    return torch.complex(out[:ml], out[ml:])


__all__ = ["Mesh", "make_mesh", "mesh_device", "check_device", "shard_of",
           "assemble", "gemm_sharded", "gemm_sharded_complex",
           "rescale_norm"]
