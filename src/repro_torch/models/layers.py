"""Shared transformer building blocks (port of ``repro.models.layers``).

Plain functions on (B, S, ...) activations in bf16 compute with f32 params,
over explicit param dicts.  Attention never materialises (S, S) scores:
``chunked_attention`` sends CUDA tensors to the hand-written flash kernel
(``kernels/csrc/flash_attention.cu``) and runs CPU tensors through the
reference's query-chunked softmax, line for line.

On a mesh the activations are DTensors.  ``set_sharding_axes`` registers
the mesh's logical axes and ``constrain`` pins an activation to the
reference's megatron-style layout at the reference's places (its
``with_sharding_constraint``, here a DTensor redistribute); with the axes
unset, or on a plain tensor, it returns its argument, so every
single-device path runs the ops it ran before.  A param is read through
``weight`` (gathered over the data axes, its tp shard kept) and a
product's partial sums are added up by ``reduced``.  A tensor the step
makes itself (positions, masks) is made on the activation's mesh
(``like``), and the blocks whose ops are per shard (attention, MoE
dispatch, the SSD chunk loop, the RG-LRU conv and scan, the vocab-sharded
lookups) run on each rank's local shards through ``on_shards``
(``local_map``).  The reference's ``chunked_map`` has no counterpart: the
port's loops are Python loops, each iteration seen.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
from repro_torch.launch.mesh import P, placements

COMPUTE_DTYPE = torch.bfloat16

_NEG = -1e30


# ---------------------------------------------------------------------------
# activation sharding on a mesh (the reference's constrain)
# ---------------------------------------------------------------------------

_MESH_AXES: dict | None = None


def set_sharding_axes(dp, tp: str, sizes: dict[str, int]) -> None:
    """dp: axis name (or tuple) for batch/FSDP; tp: tensor axis; sizes: name->size."""
    global _MESH_AXES
    dp_t = dp if isinstance(dp, tuple) else (dp,)
    _MESH_AXES = {
        "dp": dp,
        "tp": tp,
        "dp_size": math.prod(sizes[a] for a in dp_t) if dp else 1,
        "tp_size": sizes.get(tp, 1),
    }


def clear_sharding_axes() -> None:
    global _MESH_AXES
    _MESH_AXES = None


def activation_spec(shape, axes) -> P:
    """The reference's spec of ``constrain(x, *axes)`` for x of ``shape``:
    logical 'dp'/'tp' per dimension as the registered mesh axes, an axis
    whose size does not divide its dimension dropped."""
    spec = []
    for dim, a in zip(shape, axes):
        if a is None:
            spec.append(None)
        else:
            size = _MESH_AXES[f"{a}_size"]
            spec.append(_MESH_AXES[a] if size and dim % size == 0 else None)
    return P(*spec)


def sharding_axes() -> dict | None:
    """The registered axes: dp, tp and their sizes (None: unset)."""
    return _MESH_AXES


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's sharding constraint on logical axes 'dp'/'tp'/None
    per dimension: a DTensor redistributed to :func:`activation_spec`'s
    placements; ``x`` itself when no axes are set or x is not a DTensor
    (a single device, or a local shard inside :func:`on_shards`)."""
    if _MESH_AXES is None:
        return x
    spec = activation_spec(x.shape, axes)
    if not is_dtensor(x):
        return x
    want = tuple(placements(spec, x.device_mesh))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor the step makes itself, on ``ref``'s mesh (replicated)
    when ``ref`` is a DTensor; else ``t``."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def on_shards(fn, out_placements, in_placements):
    """``fn`` run on each rank's local shards (``local_map``) when its first
    argument is a DTensor: each DTensor argument is redistributed to its
    entry of ``in_placements`` (None for a non-tensor argument) and ``fn``'s
    results are laid out by ``out_placements`` (one tuple of placements,
    or a tuple of them for several results); on plain tensors ``fn``
    itself.

    An argument replicated over a mesh axis along which the results differ
    (the ranks do different work) gets a gradient that is a partial sum
    over that axis; along an axis where the results are replicated too,
    the work is the same on every rank, and so is its gradient."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    several = isinstance(out_placements[0], tuple)
    outs = out_placements if several else (out_placements,)
    varies = [any(not out[i].is_replicate() for out in outs) for i in range(len(outs[0]))]

    def run(*args):
        if not is_dtensor(args[0]):
            return fn(*args)
        moved = [a.redistribute(a.device_mesh, pl)
                 if is_dtensor(a) and tuple(a.placements) != tuple(pl) else a
                 for a, pl in zip(args, in_placements)]
        grads = tuple(None if pl is None else [Partial() if p.is_replicate() and v else p
                                                for p, v in zip(pl, varies)]
                      for pl in in_placements)
        # local_map reads a list as one result's placements, a tuple as several
        return local_map(fn, out_placements=tuple(map(list, outs)) if several else list(outs[0]),
                         in_placements=tuple(None if pl is None else list(pl)
                                             for pl in in_placements),
                         in_grad_placements=grads, device_mesh=args[0].device_mesh)(*moved)

    return run


def mesh_placements(x, spec: P) -> tuple:
    """``spec``'s placements on DTensor x's mesh."""
    return tuple(placements(spec, x.device_mesh))


def weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A param as a product reads it, in ``dtype``; on a mesh cast, then
    gathered over the data axes and kept in its tp shard (FSDP: stored
    sharded over dp, read whole over dp)."""
    w = w.to(dtype)
    if not is_dtensor(w) or _MESH_AXES is None:
        return w
    dp = _MESH_AXES["dp"]
    dp_axes = dp if isinstance(dp, tuple) else (dp,)
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in dp_axes else pl for i, pl in enumerate(w.placements))
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


def reduced(y: torch.Tensor) -> torch.Tensor:
    """A product's result with its partial sums (a contraction over a
    sharded dimension, on a mesh) added up; else ``y`` itself."""
    if not is_dtensor(y) or not any(pl.is_partial() for pl in y.placements):
        return y
    return y.redistribute(y.device_mesh, tuple(Replicate() if pl.is_partial() else pl
                                               for pl in y.placements))


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim).  A DTensor whose
    last dimension is sharded over an axis that does not divide ``heads``
    is first gathered over that axis: the split cannot carry such a shard
    (GSPMD moves it in one all-to-all, through a strided layout that
    DTensor's placements do not express)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Shard

        mesh, last = t.device_mesh, t.ndim - 1
        want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == last
                     and heads % mesh.size(i) else pl for i, pl in enumerate(t.placements))
        if want != tuple(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(*t.shape[:-1], heads, head_dim)


def write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, slot] = new`` in place (cache (B, S, ...), new (B, ...)).
    On a mesh each rank writes its own shard: where the cache's S is
    sharded, only the rank that holds ``slot``."""
    if not is_dtensor(cache):
        cache[:, slot] = new
        return
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    local_shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    # new's layout: the cache's without its S dimension
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == 1
                 else Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > 1 else pl
                 for pl in cache.placements)
    if tuple(new.placements) != want:
        new = new.redistribute(mesh, want)
    at = slot - offset[1]
    if 0 <= at < local_shape[1]:
        cache.to_local()[:, at] = new.to_local()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (full or fractional -- chatglm applies RoPE to
# half the head dims: rope_fraction = 0.5)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, fraction: float = 1.0,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    d_rot = int(dh * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    half = d_rot // 2
    freqs = like(x, theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs[None, :]  # (S, half)
        ang = ang[None, :, None, :]  # (1, S, 1, half)
    else:
        ang = positions[..., None].float() * freqs  # (B, S, half)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Kv, Dh) -> (B, S, Kv*n_rep, Dh) for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(b, s, kv * n_rep, dh)


def window_slices(sq: int, sk: int, window: int, q_chunk: int) -> list[tuple[int, int, int, int]]:
    """The reference's sliding-window key slice of each query chunk:
    ``(q_start, q_len, k_start, span)`` with span = min(sk, window + q_chunk -
    1) and k_start = clip(q_start + q_chunk - span, 0, sk - span); q_chunk
    becomes sq where it does not divide sq."""
    if sq % q_chunk:
        q_chunk = sq
    span = min(sk, window + q_chunk - 1)
    return [(q_start, q_chunk, min(max(q_start + q_chunk - span, 0), sk - span), span)
            for q_start in range(0, sq, q_chunk)]


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Memory-bounded attention: q (B,Sq,H,Dh), k/v (B,Sk,Kv,Dh) -> (B,Sq,H,Dh).

    A CUDA tensor goes to the flash kernel, with no (Sq, Sk) matrix and no
    repeated kv heads.  A CPU tensor runs the reference's computation:
    queries in chunks of q_chunk, GQA by repeating kv heads, and for a
    sliding window the keys of each chunk sliced to
    :func:`window_slices`' ``[k_start, k_start + span)``.

    On the card, every mask but a window without causality is one launch
    over all keys, ``q_chunk`` unused: there the slice drops no visible key.
    A window without causality is one launch per query chunk, on the
    chunk's key slice, with the chunk's and the slice's positions passed to
    the kernel (``q_offset``, ``k_offset``) so that its window mask reads
    absolute positions: the reference's function, whose slice drops the
    keys after the chunk (but where the clip at 0 widens the first chunks'
    slice).  The two compute one function wherever some key is visible to
    every query; where none is, the kernel writes 0 and the chunked softmax
    averages all keys.

    Training: where grad is enabled and q, k or v requires it, the same
    launches go through ``ops.attention``'s autograd Function (the forward's
    training instantiation, then the backward kernels); on the CPU autograd
    differentiates the chunked softmax, as XLA does the reference's.
    """
    if is_dtensor(q):
        return _attention_on_mesh(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    if q.is_cuda:
        if window is None or causal:
            return ops.attention(q, k, v, causal=causal, window=window)
        return window_chunk_attention(q, k, v, window, q_chunk)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    scale = dh**-0.5
    kf = _repeat_kv(k, n_rep)
    vf = _repeat_kv(v, n_rep)

    if sq % q_chunk:
        q_chunk = sq  # fall back to a single chunk for odd lengths
    n_chunks = sq // q_chunk
    # only the last (window + q_chunk - 1) keys can be visible
    slices = window_slices(sq, sk, window, q_chunk) if window is not None else None

    kpos_all = torch.arange(sk, device=q.device)

    def one_chunk(ci: int) -> torch.Tensor:
        q_start = ci * q_chunk
        qc = q[:, q_start : q_start + q_chunk]
        qpos = q_start + torch.arange(q_chunk, device=q.device)
        if window is not None:
            _, _, k_start, span = slices[ci]
            kc = kf[:, k_start : k_start + span]
            vc = vf[:, k_start : k_start + span]
            kpos = k_start + torch.arange(span, device=q.device)
        else:
            kc, vc, kpos = kf, vf, kpos_all
        logits = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * scale
        mask = torch.ones((q_chunk, kpos.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(mask[None, None], logits, _NEG)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vc.float()).to(q.dtype)

    return torch.cat([one_chunk(ci) for ci in range(n_chunks)], dim=1)


def _attention_on_mesh(q, k, v, **kw) -> torch.Tensor:
    """``chunked_attention`` of DTensors: each rank attends its local shards
    (the flash kernel on the card, the chunked softmax on meta or the CPU)
    with batch over dp and heads over tp where they divide.  k and v come
    pinned on head_dim over tp (the reference's layout, which no kernel
    takes): they are redistributed to the heads' layout here, after their
    kv heads are repeated up to lcm(Kv, tp) where tp does not divide Kv, so
    that each rank holds the kv heads of its query heads."""
    if _MESH_AXES is None:
        raise RuntimeError("attention on DTensors needs set_sharding_axes")
    b, _, h, _ = q.shape
    kv = k.shape[2]
    dp = _MESH_AXES["dp"] if b % _MESH_AXES["dp_size"] == 0 else None
    tp_size = _MESH_AXES["tp_size"]
    tp = _MESH_AXES["tp"] if h % tp_size == 0 else None
    if tp is not None and kv % tp_size:
        rep = math.lcm(kv, tp_size) // kv
        k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    pl = mesh_placements(q, P(dp, None, tp, None))
    return on_shards(lambda ql, kl, vl: chunked_attention(ql, kl, vl, **kw),
                     out_placements=pl, in_placements=(pl, pl, pl))(q, k, v)


def window_chunk_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, q_chunk: int
) -> torch.Tensor:
    """A window without causality, as the reference's chunks compute it:
    ``ops.attention`` once per query chunk on its key slice
    (:func:`window_slices`), the offsets telling the kernel where both lie.
    On a CUDA tensor each chunk is one flash launch; on the CPU the kernel's
    plain version."""
    parts = []
    for q_start, q_len, k_start, span in window_slices(q.shape[1], k.shape[1], window, q_chunk):
        parts.append(ops.attention(
            q[:, q_start:q_start + q_len].contiguous(),
            k[:, k_start:k_start + span].contiguous(),
            v[:, k_start:k_start + span].contiguous(),
            causal=False, window=window, q_offset=q_start, k_offset=k_start))
    return torch.cat(parts, dim=1)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, S_cache, Kv, Dh)
    v_cache: torch.Tensor,
    cur_len: int,  # number of valid cache entries
    *,
    ring: bool = False,  # True when the cache is a sliding-window ring buffer
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache.

    Plain PyTorch on every device, as the reference's einsum: decoding runs
    no kernel."""
    b, _, h, dh = q.shape
    s_cache, kv = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kv
    kf = _repeat_kv(k_cache, n_rep)
    vf = _repeat_kv(v_cache, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * dh**-0.5
    n_valid = min(cur_len, s_cache) if ring else cur_len  # a wrapped ring is all valid
    valid = like(q, torch.arange(s_cache, device=q.device) < n_valid)
    logits = torch.where(valid[None, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_apply(x: torch.Tensor, p: dict, activation: str, lead: str | None = "dp") -> torch.Tensor:
    """x: (B, S, D).  p: {"w1": (D,F), "w2": (F,D)[, "w1g": (D,F)]}.  The
    hidden activation is pinned with its F over tp and its leading
    dimension over ``lead``."""
    w1 = weight(p["w1"], x.dtype)
    w2 = weight(p["w2"], x.dtype)
    if activation == "silu_glu":
        g = x @ weight(p["w1g"], x.dtype)
        h = F.silu(x @ w1) * g
    elif activation == "sq_relu":  # nemotron: squared ReLU
        h = torch.square(F.relu(x @ w1))
    elif activation == "gelu":  # jax.nn.gelu's default is the tanh form
        h = F.gelu(x @ w1, approximate="tanh")
    else:
        raise ValueError(activation)
    h = constrain(h, *((lead,) + (None,) * (h.ndim - 2) + ("tp",)))
    return reduced(h @ w2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0 (negative labels are masked)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
