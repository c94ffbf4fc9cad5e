"""Elastic restart: reshard the per-worker DGC state across a world-size
change (host code, run once at restore).

Counterpart of ``dgc_tpu/resilience/elastic.py`` over the port's
checkpoint format: one dict of named CPU tensors a worker (``w<r>.pt``:
``memory:<key>``, ``batch_stats``, ``generator`` and, for a model with
dropout, ``dropout_generator``). The rules are the reference's, with
exact conservation of the error-feedback mass:

* **merge** (``from % to == 0``): a worker's momentum and velocity are
  the gradient mass it has not sent, so each group of k parents is summed
  into one child (accumulated in f32, rounded once to the state's dtype).
  The flat engine defers its transmit mask (``sent_bits`` is applied on
  the next compensate's read), so each parent's pending mask is folded
  first (:func:`fold_pending_mask`); summing the raw buffers would bring
  back mass already sent.
* **split** (``to % from == 0``): the first child of each parent inherits
  the parent's buffers bitwise (its pending record included); its
  siblings start with zero memory.
* **collapse** (neither divides): everything merges into child 0, the
  others start empty.
* **BatchNorm statistics** are running statistics, not mass: a merge
  averages them, a split copies them to every child, a collapse gives
  every child the global mean.
* **Sampling and dropout generators** (the port checkpoints them; the
  reference folds its keys from the step and has none): a child that
  carries a parent's buffers (a merged child, a split's first child, a
  collapse's child 0) takes the generators of its first parent; a child
  that starts empty keeps the generators a fresh run seeds for its rank.

Every memory key must be declared: additive error-feedback mass
(:data:`~dgc_tpu_torch.compression.memory.ELASTIC_ADDITIVE_PREFIXES`:
``momentums*`` and ``velocities*`` in f32 or bf16, which also hold the
int8 error feed's residual) or the transmit record ``sent_bits``; any
other key is refused. Per-worker optimizer state (the Adasum scheme) has
no mass-conserving merge and is refused, as is a change of the two-tier
group size (its memory is per node).
"""

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dgc_tpu_torch.compression.memory import ELASTIC_ADDITIVE_PREFIXES

__all__ = ["keep_from_bits_np", "fold_pending_mask", "reshard_workers",
           "resolve_batch_geometry"]

Tensors = Dict[str, torch.Tensor]

_MEM = "memory:"
_GENERATORS = ("generator", "dropout_generator")


def keep_from_bits_np(bits: np.ndarray, total: int) -> np.ndarray:
    """Packed int32 word record -> bool keep mask ``[total]`` (True = not
    transmitted): flat position ``p`` lives in word ``(p // 4096) * 128 +
    (p % 128)``, bit ``(p // 128) % 32``."""
    words = np.asarray(bits).astype(np.uint32).reshape(-1, 1, 128)
    m = np.arange(32, dtype=np.uint32)[None, :, None]
    keep = ((words >> m) & np.uint32(1)) == 0
    return keep.reshape(-1)[:int(total)]


def fold_pending_mask(mem: Dict[str, torch.Tensor],
                      momentum_masking: bool = True,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """One worker's flat-engine memory (keys ``<prefix>velocities_c``,
    ``<prefix>momentums_c``, ``<prefix>sent_bits``) with its deferred
    transmit mask applied to the velocity (and the momentum under
    ``momentum_masking``) and the record cleared; kept coordinates stay
    bitwise. A memory without ``sent_bits`` (the per-tensor path masks
    at once) passes through."""
    bits_key = prefix + "sent_bits"
    if bits_key not in mem:
        return mem
    out = dict(mem)
    bits = mem[bits_key]
    vc = mem.get(prefix + "velocities_c")
    total = int(vc.shape[-1]) if vc is not None else 0
    if total and bits.numel():
        keep = torch.from_numpy(keep_from_bits_np(bits.cpu().numpy(),
                                                  total).copy())
        out[prefix + "velocities_c"] = torch.where(
            keep, vc, torch.zeros((), dtype=vc.dtype))
        if momentum_masking and prefix + "momentums_c" in mem:
            mc = mem[prefix + "momentums_c"]
            out[prefix + "momentums_c"] = torch.where(
                keep, mc, torch.zeros((), dtype=mc.dtype))
    out[bits_key] = torch.zeros_like(bits)
    return out


def _refuse_per_worker_opt():
    raise NotImplementedError(
        "elastic restart is not supported with per-worker optimizer state "
        "(the Adasum delta-optimizer scheme): optimizer moments are not "
        "additive across workers, so no mass-conserving merge exists — "
        "resume at the original world size or restart the optimizer from "
        "scratch")


def _check_keys(worker: Tensors) -> None:
    for name in worker:
        if name in _GENERATORS or name == "batch_stats":
            continue
        if name.startswith("opt:"):
            _refuse_per_worker_opt()
        parts = name.split(":")
        if parts[0] == "memory" and (
                parts[-1] == "sent_bits"
                or any(p.startswith(ELASTIC_ADDITIVE_PREFIXES)
                       for p in parts[1:])):
            continue
        raise ValueError(
            f"cannot elastically reshard checkpoint key {name!r}: its "
            "merge semantics are undeclared — extend compression.memory."
            "ELASTIC_ADDITIVE_PREFIXES (if it is additive error-feedback "
            "mass) or teach resilience/elastic.py its reduction")


def _sum(ws: List[Tensors], keys) -> Tensors:
    """Float keys summed in f32 and rounded once; integer keys (transmit
    records already cleared by the fold) from the first."""
    out = {}
    for k in keys:
        x0 = ws[0][k]
        if not x0.is_floating_point():
            out[k] = x0.clone()
            continue
        acc = torch.zeros(x0.shape, dtype=torch.float32)
        for w in ws:
            acc = acc + w[k].to(torch.float32)
        out[k] = acc.to(x0.dtype)
    return out


def _mean(ws: List[torch.Tensor]) -> torch.Tensor:
    acc = torch.zeros(ws[0].shape, dtype=torch.float32)
    for w in ws:
        acc = acc + w.to(torch.float32)
    return (acc / np.float32(len(ws))).to(ws[0].dtype)


def _zeros(w: Tensors, keys) -> Tensors:
    return {k: torch.zeros_like(w[k]) for k in keys}


def reshard_workers(parents: List[Tensors], fresh: Dict[int, Tensors],
                    from_topo: Dict[str, int], to_topo: Dict[str, int], *,
                    momentum_masking: bool = True,
                    per_worker_opt: bool = False,
                    log: Callable[[str], None] = print
                    ) -> Dict[int, Tensors]:
    """The workers ``fresh`` names (by global rank of the new world; their
    dicts are a fresh run's: the template of names, shapes and dtypes and
    the generators an empty child keeps) from the ``parents`` of the old
    world (``parents[r]``: worker r's checkpoint dict)."""
    fw, tw = int(from_topo["world"]), int(to_topo["world"])
    if fw <= 0 or tw <= 0:
        raise ValueError(f"world sizes must be positive, got {fw}->{tw}")
    fl = int(from_topo.get("num_local_workers", 1) or 1)
    tl = int(to_topo.get("num_local_workers", 1) or 1)
    if fl != tl:
        raise RuntimeError(
            f"elastic restart cannot reshard across tier configurations "
            f"(num_local_workers {fl} -> {tl}): the two-tier error-"
            "feedback memory has per-node semantics — restart with the "
            "same num_local_workers or a fresh experiment directory")
    if per_worker_opt:
        _refuse_per_worker_opt()
    if len(parents) != fw:
        raise ValueError(f"{len(parents)} worker files for a world of {fw}")
    for p in parents:
        _check_keys(p)
    mem_keys = [k for k in parents[0] if k.startswith(_MEM)]
    folded = [fold_pending_mask(p, momentum_masking, prefix=_MEM)
              for p in parents]
    out = {}
    for c, tmpl in fresh.items():
        if fw == tw:
            src = parents[c]
            child = {k: src[k] for k in src}
        elif fw % tw == 0:
            k = fw // tw
            group = list(range(c * k, (c + 1) * k))
            child = _sum([folded[r] for r in group], mem_keys)
            child["batch_stats"] = _mean([parents[r]["batch_stats"]
                                          for r in group])
            child.update({g: parents[group[0]][g] for g in _GENERATORS
                          if g in parents[0]})
        elif tw % fw == 0:
            k = tw // fw
            src = parents[c // k]
            if c % k == 0:
                child = {m: src[m] for m in mem_keys}
                child.update({g: src[g] for g in _GENERATORS if g in src})
            else:
                child = _zeros(src, mem_keys)
                child.update({g: tmpl[g] for g in _GENERATORS if g in tmpl})
            child["batch_stats"] = src["batch_stats"]
        else:
            if c == 0:
                child = _sum(folded, mem_keys)
                child.update({g: parents[0][g] for g in _GENERATORS
                              if g in parents[0]})
            else:
                child = _zeros(parents[0], mem_keys)
                child.update({g: tmpl[g] for g in _GENERATORS if g in tmpl})
            child["batch_stats"] = _mean([p["batch_stats"] for p in parents])
        out[c] = child
    if fw % tw == 0 and fw != tw:
        log(f"[elastic] merging {fw} workers -> {tw} ({fw // tw}:1, error "
            "feedback summed, BN stats mean-reduced)")
    elif tw % fw == 0 and fw != tw:
        log(f"[elastic] splitting {fw} workers -> {tw} (1:{tw // fw}, one "
            "child inherits the parent residual bitwise, siblings start "
            "empty; BN stats copied)")
    elif fw != tw:
        log(f"[elastic] world {fw} -> {tw} is not divisible either way: "
            "collapsing all residual mass into worker 0 (exact total mass, "
            "but per-worker/data alignment is lost)")
    return out


def resolve_batch_geometry(from_world: int, to_world: int, nbps: int,
                           preserve: bool = True
                           ) -> Tuple[int, Optional[str]]:
    """The degraded mode's ``num_batches_per_step``: keeping ``nbps *
    world`` keeps the global batch, the scaled learning rate, the steps an
    epoch and the meaning of a mid-epoch cursor. Returns ``(new nbps,
    note)``; raises when no integer nbps keeps the product."""
    fw, tw, nbps = int(from_world), int(to_world), int(nbps)
    if nbps < 1:
        raise ValueError(f"num_batches_per_step must be >= 1, got {nbps}")
    if fw == tw:
        return nbps, None
    if not preserve:
        return nbps, (
            f"preserve_global_batch=False: world {fw} -> {tw} changes the "
            f"effective global batch by {tw / fw:g}x (LR rescales with it)")
    if fw % tw == 0:
        k = fw // tw
        return nbps * k, (
            f"cohort shrank {fw} -> {tw}: raising num_batches_per_step "
            f"{nbps} -> {nbps * k} to preserve the global batch and LR")
    if tw % fw == 0:
        k = tw // fw
        if nbps % k == 0:
            return nbps // k, (
                f"cohort grew {fw} -> {tw}: lowering num_batches_per_step "
                f"{nbps} -> {nbps // k} to preserve the global batch and LR")
        raise RuntimeError(
            f"cannot preserve the global batch growing {fw} -> {tw} "
            f"workers: num_batches_per_step {nbps} is not divisible by "
            f"{k}. Relaunch with a num_batches_per_step a multiple of {k}, "
            f"or set train.elastic.preserve_global_batch False to accept a "
            f"{k}x larger global batch")
    raise RuntimeError(
        f"elastic restart {fw} -> {tw} workers cannot preserve the "
        f"global batch: neither world size divides the other and "
        f"num_batches_per_step is integral. Relaunch with a world size "
        f"that divides (or is a multiple of) {fw}, or set "
        "train.elastic.preserve_global_batch False to accept the "
        "changed batch geometry")
