"""Checkpoint save / resume / best, with the DGC memory.

Counterpart of ``dgc_tpu/training/checkpoint.py``'s ``CheckpointManager``,
its behaviour in the port's own format (the JAX package writes orbax
directories; neither reads the other's files, and ``interop.py`` carries
a restored JAX state across):

* **Layout.** One directory ``e<N>/`` an epoch: ``state.pt`` (the
  replicated state: step, parameters, optimizer state, and the step
  guards' state under ``guards:<key>`` when the run has guards), one
  ``w<r>.pt`` per worker r (its memory, BatchNorm statistics, sampling
  generator's state and, for a model with dropout, its dropout
  generator's; under the Adasum scheme its own optimizer state) and
  ``meters.json`` (the epoch, the meters — an emergency save's
  ``preempt_batch``, the last batch it trained, among them — and the
  ``_topology`` the state was written under). ``latest.json`` names the
  newest epoch and is published with ``os.replace``; ``best/`` is a copy
  of the epoch with the best metric; the last ``keep`` epochs are kept.
* **Files.** Each ``.pt`` holds a flat dict of named CPU tensors, written
  with ``torch.save`` and read back with ``torch.load(weights_only=True)``;
  nested names join with ``:`` (the per-tensor memory's
  ``memory:momentums:<param name>``; parameter names hold ``/``).
* **Atomic save.** An epoch is written to ``e<N>.tmp`` and published with
  one ``os.replace``; saving an epoch again overwrites it.
* **Restore** walks ``latest``, then the kept epochs newest first, and
  falls back past a checkpoint that does not load (a torn file, another
  layout). A ``_topology`` that differs from the caller's raises
  :class:`TopologyMismatch` before any state file is read, unless
  ``elastic=True``: then every worker file of the saved world is read and
  resharded onto the caller's (``resilience.elastic.reshard_workers``),
  and the meters carry an ``_elastic`` record. A checkpoint written
  without guards restores into a guarded run with fresh guard state (and
  a guarded one into an unguarded run without it).
* **Several processes.** Under a ``torch.distributed`` group every
  process writes the files of the workers it holds and the coordinator
  (rank 0) the replicated state; the coordinator alone publishes,
  rotates and copies ``best``, fenced by barriers, and each process
  restores the workers it holds. The directory must be shared.

Not ported: the JAX manager's migration of legacy ``sent_c`` /
``keep_c`` memory records (no port checkpoint predates the packed
record).
"""

import json
import os
import shutil
import tempfile
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dgc_tpu_torch.parallel.multihost import is_coordinator
from dgc_tpu_torch.resilience import elastic as _elastic
from dgc_tpu_torch.training.state import TrainState

__all__ = ["CheckpointManager", "TopologyMismatch", "state_tensors",
           "load_state_tensors"]

Tensors = Dict[str, torch.Tensor]

_STATE = "state.pt"
_SEP = ":"
_GUARDS = "guards" + _SEP


class TopologyMismatch(RuntimeError):
    """The checkpoint was written under another process / worker
    topology: a configuration error, never a reason to fall back."""


def _worker_file(rank: int) -> str:
    return f"w{rank}.pt"


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU, holding only its own elements (``torch.save`` of
    a view writes the whole storage)."""
    t = t.detach().cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t


def _flatten(tree, prefix: str, out: Tensors, conv) -> Tensors:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{_SEP}{k}", out, conv)
    else:
        out[prefix] = conv(tree)
    return out


def _unflatten(template, prefix: str, flat: Tensors, device):
    if isinstance(template, Mapping):
        return {k: _unflatten(v, f"{prefix}{_SEP}{k}", flat, device)
                for k, v in template.items()}
    return flat[prefix].to(device)


def state_tensors(state: TrainState, gens: Sequence[torch.Generator],
                  ranks: Sequence[int], host: bool = True,
                  dropout_gens: Optional[Sequence[torch.Generator]] = None
                  ) -> Tuple[Tensors, Dict[int, Tensors]]:
    """A train state as checkpoint tensors: the replicated dict (step,
    parameters, the optimizer state's fields) and one dict per local
    worker, by global rank (memory, BatchNorm statistics, the sampling
    generator's state and, where given, the dropout generator's). With
    ``host=False`` the state's own tensors, not copies on the CPU: a
    template of names, shapes and dtypes for
    :meth:`CheckpointManager.restore`."""
    conv = _host if host else torch.Tensor.detach
    rep = {"step": torch.tensor(state.step, dtype=torch.int64),
           "params": conv(state.params)}
    per_worker = isinstance(state.opt_state, list)
    if not per_worker:
        _opt_tensors(state.opt_state, rep, conv)
    if state.guards is not None:
        _flatten(state.guards, "guards", rep, conv)
    workers = {}
    for w, r in enumerate(ranks):
        d = _flatten(state.memory[w], "memory", {}, conv)
        d["batch_stats"] = conv(state.batch_stats[w])
        d["generator"] = gens[w].get_state()
        if dropout_gens:
            d["dropout_generator"] = dropout_gens[w].get_state()
        if per_worker:
            _opt_tensors(state.opt_state[w], d, conv)
        workers[r] = d
    return rep, workers


def _opt_tensors(opt, out: Tensors, conv) -> None:
    for field in opt._fields:
        v = getattr(opt, field)
        if v is None:
            continue
        out[f"opt{_SEP}{field}"] = (conv(v) if torch.is_tensor(v)
                                    else torch.tensor(v, dtype=torch.int64))


def _opt_from(opt, src: Tensors, device):
    fields = {}
    for field in opt._fields:
        v = getattr(opt, field)
        key = f"opt{_SEP}{field}"
        if v is None:
            fields[field] = None
        elif torch.is_tensor(v):
            fields[field] = src[key].to(device)
        else:
            fields[field] = int(src[key])
    return type(opt)(**fields)


def load_state_tensors(state: TrainState, gens: Sequence[torch.Generator],
                       ranks: Sequence[int], rep: Tensors,
                       workers: Dict[int, Tensors],
                       dropout_gens: Optional[
                           Sequence[torch.Generator]] = None
                       ) -> TrainState:
    """The inverse of :func:`state_tensors` over a live ``state`` of the
    same structure: returns the restored state on the live state's
    device and sets each local worker's generators. Guard state missing
    from ``rep`` (a checkpoint written without guards) stays the live
    state's."""
    device = state.params.device
    per_worker = isinstance(state.opt_state, list)
    memory, stats, opts = [], [], []
    for w, r in enumerate(ranks):
        d = workers[r]
        memory.append(_unflatten(state.memory[w], "memory", d, device))
        stats.append(d["batch_stats"].to(device))
        gens[w].set_state(d["generator"])
        if dropout_gens:
            dropout_gens[w].set_state(d["dropout_generator"])
        if per_worker:
            opts.append(_opt_from(state.opt_state[w], d, device))
    guards = state.guards
    if guards is not None and any(k.startswith(_GUARDS) for k in rep):
        guards = _unflatten(guards, "guards", rep, device)
    return TrainState(step=int(rep["step"]), params=rep["params"].to(device),
                      opt_state=(opts if per_worker
                                 else _opt_from(state.opt_state, rep,
                                                device)),
                      memory=memory, batch_stats=stats, guards=guards)


def _check_like(got: Tensors, want: Tensors, what: str) -> None:
    """Keys, shapes and dtypes equal, else ``ValueError``."""
    if set(got) != set(want):
        raise ValueError(f"{what}: keys differ from the live state's: "
                         f"{sorted(set(got) ^ set(want))[:4]}")
    for k, t in want.items():
        g = got[k]
        if g.shape != t.shape or g.dtype != t.dtype:
            raise ValueError(f"{what}: {k} is {tuple(g.shape)} {g.dtype}, "
                             f"the live state's {tuple(t.shape)} {t.dtype}")


def _write_json_atomic(path: str, obj) -> None:
    """Publish a JSON document with ``mkstemp`` + ``fsync`` +
    ``os.replace`` in its own directory."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class CheckpointManager:
    """Epoch checkpoints under ``directory``; see the module docstring."""

    #: epochs kept (the reference keeps 3)
    keep = 3

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, f"e{epoch}")

    def _meta_path(self) -> str:
        return os.path.join(self.directory, "latest.json")

    def save(self, epoch: int, replicated: Tensors,
             workers: Dict[int, Tensors], meters: Dict[str, float],
             best: bool = False,
             topology: Optional[Dict[str, int]] = None) -> str:
        """Write epoch ``epoch`` (``replicated`` by the coordinator,
        ``workers`` — this process's, by global rank — by every process),
        publish it, point ``latest`` at it, copy it to ``best`` when
        ``best``, and drop the epoch ``keep`` before it. Every process of
        a group calls this. Returns the epoch's directory."""
        coord = is_coordinator()
        path = self._epoch_dir(epoch)
        tmp = path + ".tmp"
        if coord:
            if os.path.exists(tmp):         # left by a crashed save
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        _barrier()
        for r, d in workers.items():
            torch.save(d, os.path.join(tmp, _worker_file(r)))
        if coord:
            torch.save(replicated, os.path.join(tmp, _STATE))
        _barrier()
        if coord:
            # meters.json goes in before the rename: the published epoch
            # is complete the instant it exists
            payload = {k: float(v) for k, v in meters.items()}
            payload["epoch"] = epoch
            if topology:
                payload["_topology"] = dict(topology)
            with open(os.path.join(tmp, "meters.json"), "w") as f:
                json.dump(payload, f)
            if os.path.exists(path):        # the same epoch again
                shutil.rmtree(path)
            os.replace(tmp, path)
            # a crash before this leaves the old complete latest.json,
            # and restore's scan of the kept epochs still finds this one
            _write_json_atomic(self._meta_path(), {"epoch": epoch})
            if best:
                best_path = os.path.join(self.directory, "best")
                if os.path.exists(best_path):
                    shutil.rmtree(best_path)
                shutil.copytree(path, best_path)
            old = self._epoch_dir(epoch - self.keep)
            if epoch - self.keep >= 0 and os.path.exists(old):
                shutil.rmtree(old)
        # no process leaves (and restores) before the pointers are written
        _barrier()
        return path

    def latest_epoch(self) -> Optional[int]:
        """The epoch ``latest.json`` names; None when it is missing or
        torn (restore then scans the kept epochs)."""
        try:
            with open(self._meta_path()) as f:
                return int(json.load(f)["epoch"])
        except (OSError, ValueError, KeyError):
            return None

    def _kept_epochs(self) -> List[int]:
        """The ``e<N>`` directories' epochs, newest first."""
        out = [int(n[1:]) for n in os.listdir(self.directory)
               if n.startswith("e") and n[1:].isdigit()
               and os.path.isdir(os.path.join(self.directory, n))]
        return sorted(out, reverse=True)

    def _candidates(self) -> List[int]:
        latest = self.latest_epoch()
        kept = self._kept_epochs()
        if latest is None:
            return kept
        return [latest] + [e for e in kept if e != latest]

    def saved_topology(self) -> Optional[Dict[str, int]]:
        """The ``_topology`` record of the checkpoint a restore would take
        first (None: nothing saved, or no record): read before the run's
        batch geometry is set, so an elastic restart can keep the global
        batch (``resilience.elastic.resolve_batch_geometry``)."""
        for e in self._candidates():
            try:
                with open(os.path.join(self._epoch_dir(e),
                                       "meters.json")) as f:
                    topo = json.load(f).get("_topology")
            except (OSError, ValueError):
                continue
            return dict(topo) if topo else None
        return None

    def restore(self, replicated: Tensors, workers: Dict[int, Tensors],
                best: bool = False,
                topology: Optional[Dict[str, int]] = None,
                elastic: bool = False, elastic_opts: Optional[Dict] = None
                ) -> Optional[Tuple[Tensors, Dict[int, Tensors], int,
                                    Dict[str, float]]]:
        """``(replicated, workers, epoch, meters)`` read from ``best/`` or
        from the newest loadable epoch; None when there is nothing to
        resume. ``replicated`` and ``workers`` are the live
        state's tensors (:func:`state_tensors`): the files must hold the
        same names, shapes and dtypes, and only the workers named in
        ``workers`` are read. ``elastic``: a checkpoint of another world
        size is resharded (``elastic_opts``: ``momentum_masking``,
        ``per_worker_opt``) instead of refused."""
        if best:
            paths = [os.path.join(self.directory, "best")]
        else:
            paths = [self._epoch_dir(e) for e in self._candidates()]
        for i, path in enumerate(paths):
            if not os.path.exists(path):
                continue
            try:
                return self._restore_one(path, replicated, workers, topology,
                                         elastic, elastic_opts or {})
            except TopologyMismatch:
                raise
            except Exception as e:   # torn or foreign files: fall back
                more = any(os.path.exists(p) for p in paths[i + 1:])
                line = (str(e).splitlines() or [type(e).__name__])[0]
                print(f"[checkpoint] incompatible checkpoint at {path}, "
                      f"ignoring: {line}"
                      + (" — falling back to the previous kept epoch"
                         if more else ""))
        return None

    def _restore_one(self, path: str, replicated: Tensors,
                     workers: Dict[int, Tensors],
                     topology: Optional[Dict[str, int]],
                     elastic: bool = False, elastic_opts: Dict = None):
        with open(os.path.join(path, "meters.json")) as f:
            meters = json.load(f)
        saved = meters.pop("_topology", None)
        mismatch = (topology is not None and saved is not None
                    and dict(saved) != dict(topology))
        if mismatch and not elastic:
            raise TopologyMismatch(
                f"checkpoint at {path} was written under topology {saved} "
                f"but this run has {dict(topology)}: resume with the same "
                "process and worker configuration, pass elastic=True "
                "(--elastic) to reshard the per-worker state across the "
                "world-size change, or start a fresh experiment directory")
        epoch = int(meters.pop("epoch"))
        rep = torch.load(os.path.join(path, _STATE), map_location="cpu",
                         weights_only=True)
        want_rep = replicated
        has = any(k.startswith(_GUARDS) for k in rep)
        wants = any(k.startswith(_GUARDS) for k in replicated)
        if wants and not has:
            print(f"[checkpoint] {path} predates the resilience guard "
                  "counters — they start fresh")
        if wants != has:
            want_rep = {k: v for k, v in replicated.items()
                        if not k.startswith(_GUARDS)}
            rep = {k: v for k, v in rep.items() if not k.startswith(_GUARDS)}
        _check_like(rep, want_rep, f"{path}/{_STATE}")
        got = {}
        if mismatch:
            got = self._reshard(path, saved, topology, workers,
                                elastic_opts or {})
            meters["_elastic"] = {
                "from_world": int(saved["world"]),
                "to_world": int(topology["world"]),
                "from_process_count": int(saved.get("process_count", 1)),
                "to_process_count": int(topology.get("process_count", 1))}
        else:
            for r in workers:
                name = os.path.join(path, _worker_file(r))
                got[r] = torch.load(name, map_location="cpu",
                                    weights_only=True)
        for r, want in workers.items():
            _check_like(got[r], want, os.path.join(path, _worker_file(r)))
        return rep, got, epoch, meters

    def _reshard(self, path, saved, topology, workers, opts):
        """Every worker file of the saved world, resharded onto the workers
        this process holds; a refusal raises :class:`TopologyMismatch`."""
        parents = [torch.load(os.path.join(path, _worker_file(r)),
                              map_location="cpu", weights_only=True)
                   for r in range(int(saved["world"]))]
        fresh = {r: {k: (v if v.device.type == "cpu" else _host(v))
                     for k, v in d.items()} for r, d in workers.items()}
        try:
            return _elastic.reshard_workers(parents, fresh, saved, topology,
                                            **opts)
        except (ValueError, RuntimeError, NotImplementedError) as e:
            raise TopologyMismatch(f"checkpoint at {path}: {e}") from e
