"""Mixture-of-Experts block with top-k routing and capacity-bounded dispatch
(port of ``repro.models.moe``).

As in the reference, assignments are sorted by expert and packed into
(E, C, D) capacity buffers, so the expert products compute top_k * tokens *
capacity_factor rows' worth of work, not n_experts x; assignments past an
expert's capacity are dropped.  What changes with the framework:

* routing takes the top k from a stable descending sort, so that equal
  probabilities keep the lower expert first, as ``lax.top_k`` does
  (``torch.topk`` promises no order on ties);
* dispatch writes only the kept rows (``index_put_``; the reference adds
  zeros for the dropped ones);
* the combine is deterministic: each assignment's weighted row goes back to
  its (token, slot) place through the inverse of the sort, and the slots are
  summed left to right.  The reference's ``out.at[st].add`` would be an
  ``index_add_`` over colliding rows, which on the card sums in the order
  its atomics land.

On a mesh (DTensors) the block runs on each rank's shards
(``layers.on_shards``): each data shard routes and dispatches its own
tokens (the capacity is of its tokens), the expert weights are gathered
over dp and keep their d_ff over tp, so each rank's products are its
slice of d_ff and the output is a partial sum over tp.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import P
from repro_torch.models.layers import activation_spec, is_dtensor, mesh_placements, mlp_apply, on_shards


def _route(xf: torch.Tensor, router: torch.Tensor, top_k: int):
    """f32 router softmax -> (probs (t, E), gate_w (t, k) renormalised,
    gate_i (t, k)), the lower expert first on ties."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w = vals[:, :top_k]
    return probs, gate_w / gate_w.sum(dim=-1, keepdim=True), idx[:, :top_k]


def _experts(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    """Every expert's MLP: x (E, C, D), or (t, D) for all experts alike ->
    (E, C or t, D), batched matrix products over the expert axis."""
    # the reference vmaps mlp_apply over the experts: its constraint sees one
    # expert's (1, C, F), so the expert axis is never pinned
    return mlp_apply(x, {"w1": p["w1"], "w1g": p.get("w1g", p["w1"]), "w2": p["w2"]}, activation,
                     lead=None)


def moe_dispatch(x: torch.Tensor, router: torch.Tensor, *, n_experts: int, top_k: int,
                 capacity_factor: float):
    """The routing and the queue positions of ``moe_apply``: x (B, S, D) ->
    dict of order (the stable sort of the flat assignments by expert), se,
    st, sw (expert, token, weight of each sorted assignment), pos (its place
    in its expert's queue), keep (pos < capacity) and capacity."""
    t = x.shape[0] * x.shape[1]
    capacity = max(1, int(capacity_factor * t * top_k / n_experts))
    _, gate_w, gate_i = _route(x.reshape(t, -1), router, top_k)
    flat_e = gate_i.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    pos = torch.arange(t * top_k, device=x.device) - torch.searchsorted(se, se, side="left")
    return {"order": order, "se": se, "st": order // top_k, "sw": gate_w.reshape(-1)[order],
            "pos": pos, "keep": pos < capacity, "capacity": capacity}


def _on_mesh(fn, x: torch.Tensor, p: dict):
    """``fn(x, p)`` with x (B, S, D) and the expert leaves on each rank's
    shards: tokens over dp where they divide, the router whole, w1/w1g
    (E, D, F) and w2 (E, F, D) with F over tp where it divides (gathered
    over dp), the output (B, S, D) a partial sum over tp."""
    if not is_dtensor(x):
        return fn(x, p)
    from torch.distributed.tensor import Partial

    keys = sorted(p)
    dp = activation_spec(x.shape, ("dp",))[0]
    tp = activation_spec(p["w1"].shape, (None, None, "tp"))[2]
    leaf = {"router": P(), "w1": P(None, None, tp), "w1g": P(None, None, tp),
            "w2": P(None, tp, None)}
    out = list(mesh_placements(x, P(dp)))
    if tp is not None:
        out[x.device_mesh.mesh_dim_names.index(tp)] = Partial()
    return on_shards(lambda xl, *leaves: fn(xl, dict(zip(keys, leaves))),
                     out_placements=tuple(out),
                     in_placements=(mesh_placements(x, P(dp)),)
                     + tuple(mesh_placements(x, leaf[k]) for k in keys))(x, *(p[k] for k in keys))


def moe_apply(x: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
              capacity_factor: float, activation: str) -> torch.Tensor:
    """x: (B, S, D).  p: router (D, E), w1/w1g (E, D, F), w2 (E, F, D)."""
    return _on_mesh(lambda xl, pl: _moe_apply(xl, pl, n_experts=n_experts, top_k=top_k,
                                              capacity_factor=capacity_factor,
                                              activation=activation), x, p)


def _moe_apply(x: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
               capacity_factor: float, activation: str) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    r = moe_dispatch(x, p["router"], n_experts=n_experts, top_k=top_k,
                     capacity_factor=capacity_factor)
    se, keep = r["se"], r["keep"]
    pos_c = torch.where(keep, r["pos"], 0)

    buf = torch.zeros((n_experts, r["capacity"], d), dtype=x.dtype, device=x.device)
    buf.index_put_((se[keep], pos_c[keep]), xf[r["st"][keep]])
    h = _experts(buf, p, activation)  # (E, C, D)

    vals = h[se, pos_c].float() * torch.where(keep, r["sw"], 0.0)[:, None]
    slots = torch.empty_like(vals)
    slots[r["order"]] = vals  # assignment a = token a // k, slot a % k
    slots = slots.reshape(t, top_k, d)
    out = slots[:, 0]
    for j in range(1, top_k):
        out = out + slots[:, j]
    return out.to(x.dtype).reshape(b, s, d)


def moe_apply_dense(x: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
                    activation: str) -> torch.Tensor:
    """Every expert on every token, combined with the renormalised top-k
    gate weights: E / top_k times the products of ``moe_apply`` and no
    dispatch (the decode form, ``cfg.moe_dense_decode``)."""
    return _on_mesh(lambda xl, pl: _moe_apply_dense(xl, pl, n_experts=n_experts, top_k=top_k,
                                                    activation=activation), x, p)


def _moe_apply_dense(x: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
                     activation: str) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    _, gate_w, gate_i = _route(xf, p["router"], top_k)
    w_full = torch.zeros((t, n_experts), dtype=torch.float32, device=x.device)
    w_full.scatter_(1, gate_i, gate_w)
    h = _experts(xf, p, activation)  # (E, t, D): xf broadcasts over the experts
    out = torch.einsum("te,etd->td", w_full, h.float())
    return out.to(x.dtype).reshape(b, s, d)


def moe_aux_loss(x: torch.Tensor, router: torch.Tensor, *, n_experts: int,
                 top_k: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean over tokens)."""
    t = x.shape[0] * x.shape[1]
    probs, _, top_i = _route(x.reshape(t, -1), router, top_k)
    frac_tokens = torch.nn.functional.one_hot(top_i, n_experts).float().mean(dim=(0, 1))
    return n_experts * torch.sum(frac_tokens * probs.mean(dim=0))
