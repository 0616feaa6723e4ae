"""Flash attention: online softmax over key tiles, causal and sliding-window
masks, every batch row and head in one launch.

    flash_attention_cuda(q, k, v, causal=True, window=None, scale=None,
                         q_offset=0, k_offset=0)
    q (B, Sq, H, dh), k and v (B, Sk, Kv, dh) -> (B, Sq, H, dh) in q's dtype

Key j is visible to query i when j < Sk, j + k_offset <= i + q_offset
(causal) and j + k_offset > i + q_offset - window (window): the offsets are
the positions of q's and k's first rows in the whole sequence, 0 on whole
sequences (``models.layers.chunked_attention`` passes a query chunk and its
key slice).  The logits are f32 dot products times ``scale`` (default
dh**-0.5), the softmax and P.V are f32, and a row with no visible key gives
0.  Query head h reads kv head h // (H // Kv) (GQA).

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas`` (body
``_flash_kernel``), reached in the JAX package through
``repro/kernels/ops.py:flash_attention``; the models there call its jnp twin
``repro/models/layers.py:chunked_attention``, and the port's
``models/layers.chunked_attention`` sends CUDA tensors here.  Source
``csrc/flash_attention.cu``, two kernels; :func:`flash_route` picks one from
the dtype and head_dim alone:

* ``wgmma`` (``flash_fwd_wgmma_kernel``): bf16 at head_dim 64, 128 and 256,
  the models' path;
* ``simt`` (``flash_fwd_kernel``): f32 at any head_dim, and bf16 at head_dim
  16 and 32, which appear only in reduced configurations.  An f32 q.k is
  not exact on bf16 tensor cores, so f32 stays on the CUDA cores.

What bounds the wgmma route on an H100: operations, on the bf16 tensor
cores.  The reference keeps p in f32 for P.V.  That needs no f32 pipe: any
f32 p >= 2**-110 is exactly p1 + p2 + p3 with p1 = bf16(p), p2 = bf16(p -
p1), p3 = p - p1 - p2, each part a bf16 and each subtraction exact
(:func:`split_bf16x3`); v is bf16 and a bf16 x bf16 product is exact in
f32, so P.V at the reference's f32 p is three bf16 products into one f32
accumulator, and QK^T (bf16 q and k) is one.  The function stays the
reference's, up to the order of the f32 sums.  At granite-3-2b's 32k
prefill (B = 1, S = 32,768, H = 32, Kv = 8, dh = 64, causal) each product is
2.2 TFLOP over the visible pairs (:func:`visible_pairs`), so the bound is
4 x 2.2 TFLOP at 989 TFLOP/s = 8.9 ms.  Beside it: the bytes (q, k, v read
once, the output written once, 335 MB) take 0.10 ms, and the 17.2 G
exponentials about 4.1 ms at the 16 results per SM per clock of the MUFU
pipe.  With P.V on the f32 CUDA cores, as the SIMT kernel runs it, the
bound would be 35.05 ms; rounding p to bf16, as library flash kernels do,
would give 4.45 ms and another function.  At recurrentgemma-2b's layer
(dh = 256, H = 10, Kv = 1, causal window 2048: 650 M visible pairs) the
bound is 1.35 ms.

What the design does about it (``flash_fwd_wgmma_kernel``): one block per
(query tile, head, batch row), the heaviest causal tiles first; one
producer warp loads Q once and keeps a ring of K/V tiles full by TMA
(128-byte swizzle, 64-column boxes, zero fill past the sequence's end, so
nothing is padded); two consumer warpgroups run QK^T as ``wgmma`` from
shared memory and the online softmax in registers (p = ex2(s log2 e - m
log2 e): one FFMA and ``ex2.approx``; masked logits are the -1e30 sentinel,
tested only in the instantiation for tiles that an edge crosses); they
split p into its three bf16 parts in the register-A fragment layout (two
conversion instructions per pair of p, the rest shifts, masks and
subtractions) and issue three register-A ``wgmma`` m64n64k16 per 16 keys
and 64 columns, in four batches a tile, so that p of one batch is computed
while the products of the batches before it run.  Each tile's P.V starts
from zero and is added to the running O on the CUDA cores, as the
reference adds each tile's dot: the tensor cores' f32 accumulation is not a
chain of round-to-nearest FMAs, and carried over a whole 32k row it drifted
past one bf16 ulp near zero.  The one-bf16-ulp checks on the card hold the
result.  The tiles and the consumers' split depend on head_dim:

* 64 and 128: 128 queries a block and 128-key tiles (3 and 2 stages); each
  consumer owns 64 query rows, S by m64n128k16;
* 256: a 128-key K or V tile would take 64 KB and O 128 registers a thread
  (about 320 with S and the split p, against the 240 of ``setmaxnreg``), so
  a block has 64 queries, tiles of 64 keys and 3 stages (230,456 B of
  shared memory), and both consumers own the same 64 rows: each computes
  the whole S (m64n64k16), the same softmax (the same instructions on the
  same data, so m and l agree bit for bit and nothing is exchanged) and
  writes its own 128 of the 256 output columns: S 32, the split p 48, O 64
  and a P.V accumulator 32 registers, ~180 in all.  S is computed twice:
  one product of five, and its exponentials, twice.

Short sequences (:func:`flash_fwd_grid`).  At the FedNL probe's backbone
layer (B 512, S 16, H 32, Kv 8, dh 64, causal) the bound is bytes: q, k, v
read and the output written once, 83.9 MB, 25 us at 3.35 TB/s; the
products are 0.1% of the tensor cores' time.  The grid of (query tile,
head, batch row) gave 16,384 blocks whose 128-row tile held 16 rows (one
consumer warpgroup idle, the other a quarter full) and whose one key tile
held 16 keys, so the block's fixed cost (barriers, ``setmaxnreg``, the
tensor maps, three TMA round trips) was the time.  The packed grid puts
128 / S whole sequences of one head in a block: the tensor maps run over
the flat (B S, H dh) rows, so one box brings 8 sequences, the grid is (B S
/ 128, H) = 2,048 blocks at the probe with both consumers full, and the
block's one key tile is its own 128 rows.  A key is visible only within its
query's sequence (the same flat position >> log2 S), causality and the
window then compare positions as within the sequence, and the tile takes the edge instantiation of
the softmax.  Each row sees the same keys as on the other grid; only the
column a key sits in, and so the order of the f32 row sums, changes.  It
takes self-attention on whole sequences (Sq = Sk, no offsets) whose S
divides 128 and is below it, at head_dim 64 and 128, in inference; the
32k prefills, training, decode and head_dim 256 keep the other grid.

Known costs left: a warpgroup waits for its S before its softmax and for
each panel's P.V before the next, so its exponentials and conversions (16
results per clock per SM each) overlap the tensor cores only in part,
through the other warpgroup and the batches; issuing the next tile's S
early would need another 64 registers a thread at head_dim 64 and 128.
Forcing the two warpgroups to alternate on the tensor cores was slower.
Causal tiles on the diagonal are computed whole.  At head_dim 256 the two
consumers run the same softmax at the same time, and S is computed twice:
with S over half of head_dim (timing only) the kernel took 14% less time on
an H100, but splitting S between the consumers and adding the halves
through shared memory (32 KB a tile each, and a barrier) took 3% more
(``scripts/flash_probe.py``).

``flash_fwd_kernel``, the port's first flash kernel: one block per
(64-query tile, head, batch row), K/V tiles in shared memory as f32, 4 x 4
logits and 4 x dh/16 outputs per thread in f32 FMA on the CUDA cores.  At
head_dim 256 (f32) its tiles take 216,064 B of shared memory (one block per
SM) and each thread 64 accumulators.

``flash_attention_plain`` is the same function in plain PyTorch, chunked
over queries (the logits of one chunk at a time), for the CPU and for
holding both kernels to it on the card.

Training (:class:`FlashAttention`, the autograd Function that
``ops.attention`` takes when a gradient is wanted):

* the forward is each route's training instantiation
  (:func:`flash_attention_train_cuda`): O unrounded in f32 and the row
  log-sum-exp ``lse`` (B, H, Sq) in f32, +inf for a row with no visible key;
  O rounded to bf16 is the inference kernel's output;
* the backward is ``csrc/flash_attention_bwd.cu``, two kernels a route
  with no atomics (:func:`flash_attention_bwd_cuda`), the dq kernel (D =
  rowsum(dO O) and dq) then the dkdv kernel (dk and dv, summed over the
  query heads of each kv head inside the block); :func:`flash_bwd_route`
  picks the route from the dtype and head_dim alone: ``wgmma``
  (``flash_bwd_dq_wgmma_kernel``, ``flash_bwd_dkdv_wgmma_kernel``) for bf16
  at head_dim 64, 128 and 256, ``simt`` (``flash_bwd_dq_kernel``,
  ``flash_bwd_dkdv_kernel``) for f32 and bf16 at 16 and 32.  It ports
  no Pallas kernel: it is the derivative that XLA takes of
  ``repro/models/layers.py:chunked_attention``.  What bounds it is
  operations: five head_dim products over the visible pairs (S, dP, dQ,
  dK, dV) at 67 TFLOP/s on the CUDA cores, or eleven bf16 products (P and
  dS in three bf16 parts, :func:`split_bf16x3`) at 989 TFLOP/s on the
  tensor cores, thirteen when both kernels recompute S and dP, as these
  do.  At granite-3-2b's training layer (B 2, S 4,096, H 32, Kv 8, dh 64,
  causal: 537 M visible pairs) that is 5.1 ms on the CUDA cores, 0.76 ms on
  the tensor cores and 0.90 ms for the thirteen; at recurrentgemma-2b's (B
  2, S 4,096, H 10, Kv 1, dh 256, causal window 2048: 126 M visible pairs)
  4.8, 0.72 and 0.85 ms, and 1.04 ms for the sixteen products that the
  head_dim-256 design runs (dq 7: both consumers compute S and dP and each
  owns half of dq's columns; dkdv 9: one consumer sums dv, the other
  computes dP and sums dk).  The wgmma kernels run
  every product on the tensor cores as the forward runs P.V: S and dP from
  shared memory, P and dS split into three register-A parts, K, Q and dO
  as MN-major B operands, the sums over tiles in the wgmma accumulators;
  the SIMT kernels stage every operand as f32 and run seven products as
  f32 FMAs;
* ``flash_attention_train_plain`` and ``flash_attention_bwd_plain`` are the
  same functions in plain PyTorch, for the CPU and the checks on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1e30  # the reference's mask sentinel (flash_attention.py:31)
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims either route takes
WGMMA_HEAD_DIMS = (64, 128, 256)  # bf16 at these runs the wgmma kernel
WGMMA_BWD_HEAD_DIMS = (64, 128, 256)  # ... and the wgmma backward kernels
PLAIN_Q_CHUNK = 512

# flash_attention_fwd (simt): q, k, v, out, batch, sq, sk, heads, kv heads,
# head_dim, is_bf16, causal, window, q_offset - k_offset, scale, stream;
# flash_attention_fwd_wgmma takes the same without is_bf16 (and the *_train
# entry points the same as theirs)
_SIMT_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
_WGMMA_ARGTYPES = _SIMT_ARGTYPES[:10] + _SIMT_ARGTYPES[11:]
# flash_attention_bwd_dq: q, k, v, o, lse, dout, dq, dsum; flash_attention_bwd_dkdv:
# q, k, v, lse, dout, dsum, dk, dv; then both: batch, sq, sk, heads, kv heads,
# head_dim, is_bf16, causal, window, q_offset - k_offset, scale, stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 8 + _SIMT_ARGTYPES[4:]
# flash_attention_bwd_dq_wgmma and flash_attention_bwd_dkdv_wgmma: the same
# without is_bf16
_BWD_WGMMA_ARGTYPES = (ctypes.c_void_p,) * 8 + _WGMMA_ARGTYPES[4:]


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, Sq, H, dh) and k, v (B, Sk, Kv, dh), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and head_dim must "
            "match and the kv heads divide the query heads"
        )


def _chunk_logits(qc, kf, q0, *, causal, window, scale, q_offset, k_offset):
    """One query chunk's f32 logits (b, kv, rep, c, sk) times ``scale``, the
    queries grouped by kv head, and the chunk's visibility mask (c, sk)."""
    b, c, h, dh = qc.shape
    sk, kv = kf.shape[1], kf.shape[2]
    qg = qc.float().reshape(b, c, kv, h // kv, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    kpos = k_offset + torch.arange(sk, device=qc.device)
    qpos = q_offset + torch.arange(q0, q0 + c, device=qc.device)[:, None]
    mask = torch.ones((c, sk), dtype=torch.bool, device=qc.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos)
    if window is not None:
        mask = mask & (kpos[None, :] > qpos - window)
    return logits, mask


def flash_attention_train_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
    q_chunk: int = PLAIN_Q_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the training forward: per chunk of
    queries, f32 logits over all keys, masked softmax, f32 P.V divided by
    the row sum (0 where no key is visible) -> O (B, Sq, H, dh) f32 and the
    row log-sum-exp (B, H, Sq) f32, +inf where no key is visible."""
    _check_shapes(q, k, v)
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    s = dh**-0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_chunk):
        qc = q[:, q0 : q0 + q_chunk]
        c = qc.shape[1]
        logits, mask = _chunk_logits(qc, kf, q0, causal=causal, window=window, scale=s,
                                     q_offset=q_offset, k_offset=k_offset)
        logits = logits.masked_fill(~mask, NEG)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(logits - m), 0.0)
        denom = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bgrqk,bkgd->bgrqd", p, vf) / torch.where(denom > 0, denom, 1.0)
        out[:, q0 : q0 + c] = o.permute(0, 3, 1, 2, 4).reshape(b, c, h, dh)
        row_lse = torch.where(denom > 0, m + torch.log(denom), torch.inf)
        lse[:, :, q0 : q0 + c] = row_lse.reshape(b, h, c)
    return out, lse


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
    q_chunk: int = PLAIN_Q_CHUNK,
) -> torch.Tensor:
    """The plain PyTorch version: :func:`flash_attention_train_plain`'s O
    rounded to q's dtype."""
    return flash_attention_train_plain(
        q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset,
        k_offset=k_offset, q_chunk=q_chunk)[0].to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
    q_chunk: int = PLAIN_Q_CHUNK,
    round_p_ds: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward, given the training
    forward's f32 O and lse and the output's gradient ``do``: per chunk of
    queries, P = exp(s - lse) on the visible keys (0 elsewhere), dP = dO V^T,
    D = rowsum(dO O), dS = P (dP - D); dq = scale dS K, and dk = scale dS^T Q
    and dv = P^T dO summed in f32 over the query heads of each kv head and
    over the chunks.  -> (dq, dk, dv) in the inputs' dtypes, each rounded
    once.  ``round_p_ds`` rounds P and dS to the inputs' dtype before their
    products, as SDPA does: another function, which the checks on the card
    take as the control that their bound must reject."""
    _check_shapes(q, k, v)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    s = dh**-0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_chunk):
        qc = q[:, q0 : q0 + q_chunk]
        c = qc.shape[1]
        logits, mask = _chunk_logits(qc, kf, q0, causal=causal, window=window, scale=s,
                                     q_offset=q_offset, k_offset=k_offset)
        grouped = (b, c, kv, h // kv, dh)
        lse_c = lse[:, :, q0 : q0 + c].reshape(b, kv, h // kv, c, 1)
        p = torch.where(mask, torch.exp(logits - lse_c), 0.0)
        doc = do[:, q0 : q0 + c].float().reshape(grouped)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", doc, vf)
        dsum = (doc * o[:, q0 : q0 + c].reshape(grouped)).sum(-1).permute(0, 2, 3, 1)
        ds = p * (dp - dsum[..., None])
        if round_p_ds:
            p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
        dq[:, q0 : q0 + c] = (torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * s).reshape(
            b, c, h, dh).to(q.dtype)
        dk += torch.einsum("bgrqk,bqgrd->bkgd", ds, qc.float().reshape(grouped))
        dv += torch.einsum("bgrqk,bqgrd->bkgd", p, doc)
    return dq, (dk * s).to(k.dtype), dv.to(v.dtype)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that takes a call: ``"wgmma"`` for bf16 at head_dim 64,
    128 or 256, ``"simt"`` for the rest (f32, and bf16 at 16 and 32)."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS else "simt"


def flash_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels that take a call: ``"wgmma"`` for bf16 at
    head_dim 64, 128 or 256, ``"simt"`` for the rest (f32, and bf16 at 16
    and 32)."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in WGMMA_BWD_HEAD_DIMS else "simt"


def flash_bwd_dkdv_grid(batch: int, sk: int, n_kv: int, lib=None) -> dict:
    """The head_dim-256 dkdv launch on the current card: the split the
    kernel's launcher takes (``split``: ``dkdv_split`` in the source, each
    key tile's (query head, 64-query tile) pairs over a cluster of that
    many blocks), its blocks, and how many of its clusters the card holds
    at once (``clusters_at_once``), from which the waves follow.  ``lib``:
    the path of another build of ``csrc/flash_attention_bwd.cu`` to ask in
    place of the package's own."""
    argtypes = (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2
    symbol = "flash_attention_bwd_dkdv_wgmma_grid"
    if lib is None:
        fn = build.function("flash_attention_bwd", symbol, argtypes)
    else:
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    split, clusters = ctypes.c_int(0), ctypes.c_int(0)
    build.check_launch(symbol, fn(batch, sk, n_kv, ctypes.addressof(split),
                                  ctypes.addressof(clusters)))
    blocks = -(-sk // 64) * n_kv * batch * split.value
    return {"split": split.value, "blocks": blocks, "clusters_at_once": clusters.value,
            "waves": blocks / max(1, clusters.value * split.value)}


def flash_fwd_grid(batch: int, sq: int, sk: int, n_heads: int, head_dim: int, *,
                   pos_off: int = 0, train: bool = False) -> dict:
    """The wgmma forward's launch for a call, worked out on the host as its
    launcher (``pack_shift`` and ``launch`` in csrc/flash_attention.cu) does:
    ``packed`` where the call is self-attention on whole sequences (Sq = Sk,
    ``pos_off`` = q_offset - k_offset = 0) of a length S that divides the
    128-row tile and is below it, at head_dim 64 or 128, in the inference
    instantiation: then one block holds 128 / S whole sequences of one
    head and the grid is (ceil(B S / 128), H, 1); else the grid of (query
    tile, head, batch row), (ceil(Sq / rows), H, B) with 128 rows a tile (64
    at head_dim 256).  ``seq_shift`` is log2 S on the packed grid."""
    rows = 64 if head_dim == 256 else 128
    packed = (not train and head_dim in (64, 128) and sq == sk and pos_off == 0
              and 1 <= sq < 128 and 128 % sq == 0)
    if packed:
        return {"packed": True, "grid": (-(-batch * sq // 128), n_heads, 1),
                "sequences_per_block": 128 // sq, "seq_shift": sq.bit_length() - 1}
    return {"packed": False, "grid": (-(-sq // rows), n_heads, batch), "sequences_per_block": 1,
            "seq_shift": -1}


def flash_fwd_grid_on_card(batch: int, sq: int, sk: int, n_heads: int, head_dim: int, *,
                           pos_off: int = 0, train: bool = False) -> dict:
    """:func:`flash_fwd_grid` as the kernel's launcher gives it
    (``flash_attention_fwd_wgmma_grid``), asked of the built library."""
    argtypes = (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
    fn = build.function("flash_attention", "flash_attention_fwd_wgmma_grid", argtypes)
    grid = (ctypes.c_int * 3)()
    shift = fn(batch, sq, sk, n_heads, head_dim, pos_off, int(train), ctypes.addressof(grid))
    return {"packed": shift >= 0, "grid": tuple(grid),
            "sequences_per_block": 128 >> shift if shift >= 0 else 1, "seq_shift": shift}


def split_bf16x3(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 p -> (p1, p2, p3), bf16 each: p1 = bf16(p), p2 = bf16(p - p1),
    p3 = bf16(p - p1 - p2), rounding to nearest.  For p >= 2**-110 the sum
    p1 + p2 + p3 is p exactly (p3 is the last 8 significant bits, and each
    subtraction is exact in f32); below, at most 2**-126 is lost.  The wgmma
    kernel computes P.V as P1 V + P2 V + P3 V."""
    p1 = p.to(torch.bfloat16)
    r = p - p1.float()
    p2 = r.to(torch.bfloat16)
    return p1, p2, (r - p2.float()).to(torch.bfloat16)


def visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs that the masks leave visible in one head of one
    batch row: key j < sk, j <= i when causal, j > i - window."""
    i = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(i, max=sk - 1) if causal else torch.full_like(i, sk - 1)
    lo = torch.clamp(i - window + 1, min=0) if window is not None else torch.zeros_like(i)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


# Where two f32 computations of one attention output are compared after
# rounding to bf16, the ulp is taken at no less than this magnitude: the f32
# sums' own rounding leaves ~1e-7 absolute (a few 2**-24 of the row's unit
# values), more than a bf16 ulp of an output that sits near 0 (seen: -4e-8
# against -6e-8, 45 bf16 ulps apart).  At 2**-14 the ulp is 2**-21 = 4.8e-7.
BF16_ULP_FLOOR = 2.0**-14


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """|got - want| per element in bf16 ulps: units of the bf16 spacing at
    max(|got|, |want|, floor) (8 significant bits: 2**(e - 8) for a magnitude
    in [2**(e-1), 2**e))."""
    g, w = got.float(), want.float()
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()), torch.tensor(floor, device=g.device))
    _, e = torch.frexp(mag)
    return (g - w).abs() / torch.ldexp(torch.ones_like(mag), e - 8)


# the largest share of a bf16 gradient's nonzero elements that the backward
# kernels may round otherwise than the plain backward (differ_share): with P
# and dS exact in three bf16 parts both round the same f32 sums once and
# differ where the sums' order crosses a rounding boundary (the CPU emulation
# of the split: at most 0.001); with P and dS rounded to bf16 once, as SDPA
# does (flash_attention_bwd_plain's round_p_ds), about 0.4 of them differ
BWD_DIFFER_SHARE = 0.2


def differ_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of the elements, among those nonzero in got or want, whose
    values differ (0 where every element is zero in both)."""
    nonzero = (got != 0) | (want != 0)
    return float((got != want)[nonzero].float().mean()) if bool(nonzero.any()) else 0.0


def _kernel_args(q, k, v, causal, window, scale, q_offset, k_offset):
    """Check what the kernels take -> ((batch, sq, sk, heads, kv heads,
    head_dim), (causal, window, q_offset - k_offset, scale)) as they take
    them."""
    _check_shapes(q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes bf16 or f32 of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must be on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs q, k, v aligned to 16 bytes")
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention has head_dim {HEAD_DIMS}, got {dh}")
    if b > 65535 or h > 65535 or max(sq, sk) >= 2**31 - 64:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)} exceed the kernel's grid")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    pos_off = int(q_offset) - int(k_offset)
    if abs(pos_off) >= 2**30:
        raise ValueError(f"offsets {q_offset}, {k_offset} exceed the kernel's positions")
    s = dh**-0.5 if scale is None else scale
    return (b, sq, sk, h, kv, dh), (int(causal), 0 if window is None else int(window), pos_off,
                                    float(s))


def _launch_fwd(train: bool, q, k, v, out, shape, masks) -> str:
    """The forward kernel of q's route into ``out`` on q's device and current
    stream (``train``: the training instantiation); returns the route."""
    route = flash_route(q.dtype, shape[-1])
    suffix = "_train" if train else ""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            fn = build.function("flash_attention", f"flash_attention_fwd_wgmma{suffix}",
                                _WGMMA_ARGTYPES)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *shape, *masks,
                      stream)
        else:
            fn = build.function("flash_attention", f"flash_attention_fwd{suffix}", _SIMT_ARGTYPES)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *shape,
                      int(q.dtype == torch.bfloat16), *masks, stream)
    build.check_launch(f"flash_attention{suffix} ({route})", code)
    return route


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Launch the route's CUDA kernel (:func:`flash_route`) on q's device and
    current stream."""
    shape, masks = _kernel_args(q, k, v, causal, window, scale, q_offset, k_offset)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = _launch_fwd(False, q, k, v, out, shape, masks)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[route] += 1
    return out


flash_attention_cuda.launches = 0
# launches by route since the last reset (ops.reset_launch_counts)
flash_attention_cuda.route_launches = {"wgmma": 0, "simt": 0}


def flash_attention_train_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The route's training instantiation -> (O (B, Sq, H, dh) f32, lse
    (B, H, Sq) f32), views of one buffer that the kernel fills."""
    shape, masks = _kernel_args(q, k, v, causal, window, scale, q_offset, k_offset)
    b, sq, _, h, _, _ = shape
    n = q.numel()
    buf = torch.empty(n + b * h * sq, dtype=torch.float32, device=q.device)
    o, lse = buf[:n].view(q.shape), buf[n:].view(b, h, sq)
    if n == 0:
        return o, lse
    route = _launch_fwd(True, q, k, v, buf, shape, masks)
    flash_attention_train_cuda.launches += 1
    flash_attention_train_cuda.route_launches[route] += 1
    return o, lse


flash_attention_train_cuda.launches = 0
flash_attention_train_cuda.route_launches = {"wgmma": 0, "simt": 0}


def _check_saved(q, do, **rows) -> None:
    """do like q; each of ``rows`` f32: ``o`` like q, the others (B, H, Sq)
    (lse, D); all contiguous, aligned, on q's device."""
    b, sq, h, _ = q.shape
    want = [("do", do, q.shape, q.dtype)] + [
        (name, t, q.shape if name == "o" else (b, h, sq), torch.float32)
        for name, t in rows.items()]
    for name, t, shape, dtype in want:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {tuple(shape)} {dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention backward needs {name} contiguous and 16-byte aligned")


def _launch_bwd(symbol: str, pointers, shape, masks, dtype) -> str:
    """The backward kernel ``symbol`` of the route (:func:`flash_bwd_route`)
    on the first pointer's device and current stream; returns the route."""
    route = flash_bwd_route(dtype, shape[-1])
    with torch.cuda.device(pointers[0].device):
        stream = torch.cuda.current_stream(pointers[0].device).cuda_stream
        ptrs = [t.data_ptr() for t in pointers]
        if route == "wgmma":
            b, sq, _, h, _, _ = shape
            if b * h * sq >= 2**31:
                raise ValueError(f"{symbol}: B * H * Sq = {b * h * sq} exceeds the kernel's rows")
            fn = build.function("flash_attention_bwd", f"{symbol}_wgmma", _BWD_WGMMA_ARGTYPES)
            code = fn(*ptrs, *shape, *masks, stream)
        else:
            fn = build.function("flash_attention_bwd", symbol, _BWD_ARGTYPES)
            code = fn(*ptrs, *shape, int(dtype == torch.bfloat16), *masks, stream)
    build.check_launch(f"{symbol} ({route})", code)
    return route


def flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, *, causal=True, window=None, scale=None,
                                q_offset=0, k_offset=0) -> tuple[torch.Tensor, torch.Tensor]:
    """The route's dq kernel (``flash_bwd_dq_wgmma_kernel`` or
    ``flash_bwd_dq_kernel``) -> (dq like q, D = rowsum(dO O) (B, H, Sq) f32,
    which :func:`flash_attention_bwd_dkdv_cuda` reads)."""
    shape, masks = _kernel_args(q, k, v, causal, window, scale, q_offset, k_offset)
    _check_saved(q, do, o=o, lse=lse)
    b, sq, _, h, _, _ = shape
    dq = torch.empty_like(q)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route = _launch_bwd("flash_attention_bwd_dq", (q, k, v, o, lse, do, dq, dsum), shape, masks,
                        q.dtype)
    flash_attention_bwd_dq_cuda.launches += 1
    flash_attention_bwd_dq_cuda.route_launches[route] += 1
    return dq, dsum


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dq_cuda.route_launches = {"wgmma": 0, "simt": 0}


def flash_attention_bwd_dkdv_cuda(q, k, v, lse, do, dsum, *, causal=True, window=None,
                                  scale=None, q_offset=0,
                                  k_offset=0) -> tuple[torch.Tensor, torch.Tensor]:
    """The route's dk/dv kernel (``flash_bwd_dkdv_wgmma_kernel`` or
    ``flash_bwd_dkdv_kernel``) -> (dk like k, dv like v), given the dq
    kernel's D."""
    shape, masks = _kernel_args(q, k, v, causal, window, scale, q_offset, k_offset)
    _check_saved(q, do, lse=lse, dsum=dsum)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = _launch_bwd("flash_attention_bwd_dkdv", (q, k, v, lse, do, dsum, dk, dv), shape,
                        masks, q.dtype)
    flash_attention_bwd_dkdv_cuda.launches += 1
    flash_attention_bwd_dkdv_cuda.route_launches[route] += 1
    return dk, dv


flash_attention_bwd_dkdv_cuda.launches = 0
flash_attention_bwd_dkdv_cuda.route_launches = {"wgmma": 0, "simt": 0}


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal=True, window=None, scale=None,
                             q_offset=0, k_offset=0):
    """The backward on the card: the dq kernel, then the dkdv kernel on the
    same stream -> (dq, dk, dv) in the inputs' dtypes.  With no query or no
    key there is nothing to launch: the gradients are zeros."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset, k_offset=k_offset)
    if q.numel() == 0 or k.numel() == 0:
        _kernel_args(q, k, v, causal, window, scale, q_offset, k_offset)
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dsum = flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, **kw)
    dk, dv = flash_attention_bwd_dkdv_cuda(q, k, v, lse, do, dsum, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: q (B, Sq, H, dh), k and v (B, Sk, Kv,
    dh) -> (B, Sq, H, dh) in q's dtype, as ``ops.attention``.  The forward
    runs the training instantiation on a CUDA tensor (the plain version on a
    CPU or meta tensor) and saves q, k, v, O in f32 and the lse; the
    backward runs the backward kernels (the plain backward on the CPU and
    on meta).  No fallback: a failed build or launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, k_offset):
        kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset,
                  k_offset=k_offset)
        forward = flash_attention_train_cuda if q.is_cuda else flash_attention_train_plain
        o, lse = forward(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o.to(q.dtype, copy=True)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        backward = flash_attention_bwd_cuda if do.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = backward(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
