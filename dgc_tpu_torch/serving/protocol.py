"""File protocol of the serving stream: atomic artifacts + JSON control.

A copy of ``dgc_tpu/serving/protocol.py`` (numpy and zipfile only): the
file names, the JSON documents and the ``.npz`` containers are the
reference's byte for byte, so either package's replica follows a stream
the other's exporter writes.

A serving directory is a single flat namespace both ends rendezvous on
(local disk in the drills; the same layout works on any
``os.replace``-atomic store):

* ``manifest.json`` — the stream head: spec meta, ``base_version``,
  ``latest_seq``, checkpoint lineage anchor, and trailing per-update
  digests. Readers poll it; it is the ONLY file whose content changes.
* ``base_v{V}.npz`` — full f32 flat snapshot for base version ``V``.
* ``delta_v{V}_{S}.npz`` — delta artifact ``S`` (1-based) on base ``V``.
* ``resync.json`` — a pending resync request (replica- or control-plane
  written); the exporter consumes it at the next publish and rebases.

Every write is ``tempfile.mkstemp`` + ``os.replace`` in the target
directory — the checkpoint manager's publish idiom — so a reader never
observes a torn file and a crashed writer leaves only ``*.tmp`` litter.
"""

import json
import os
import tempfile
import zipfile
from typing import Dict, Optional

import numpy as np

__all__ = [
    "MANIFEST", "RESYNC_REQUEST", "base_path", "delta_path",
    "write_json_atomic", "write_text_atomic", "read_json", "read_manifest",
    "save_npz_atomic", "load_npz", "request_resync",
    "read_resync_request", "clear_resync_request",
]

MANIFEST = "manifest.json"
RESYNC_REQUEST = "resync.json"


def base_path(serving_dir: str, version: int) -> str:
    return os.path.join(serving_dir, f"base_v{int(version)}.npz")


def delta_path(serving_dir: str, version: int, seq: int) -> str:
    return os.path.join(serving_dir, f"delta_v{int(version)}_{int(seq)}.npz")


def write_json_atomic(path: str, obj: Dict) -> None:
    """Publish a JSON document atomically (mkstemp + os.replace in the
    destination directory, so the rename never crosses filesystems)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_text_atomic(path: str, text: str, prefix: str = ".atomic.",
                      suffix: str = ".tmp") -> None:
    """Publish a text file with the same mkstemp+fsync+replace discipline
    as :func:`write_json_atomic` — the one choke point for every
    non-JSON publish (the supervisor env-file) so the model checker
    verifies a single idiom."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=prefix, suffix=suffix)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_json(path: str) -> Optional[Dict]:
    """Read a JSON document; None when absent or torn mid-replace (the
    caller polls, so transient unreadability is just 'not yet')."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def read_manifest(serving_dir: str) -> Optional[Dict]:
    return read_json(os.path.join(serving_dir, MANIFEST))


def save_npz_atomic(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """np.savez to an explicit tmp path in the destination directory,
    then os.replace — same publish idiom as the JSON side."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        # savez appends .npz unless the name already ends with it; give
        # it an exact .npz path so the replace source is deterministic
        tmp_npz = tmp[:-4]
        os.replace(tmp, tmp_npz)
        with open(tmp_npz, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_npz, path)
    except BaseException:
        for t in (tmp, tmp[:-4]):
            try:
                os.unlink(t)
            except OSError:
                pass
        raise


def load_npz(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Load an artifact; None when absent (a gap) or unreadable. The
    catch set covers every shape a truncated zip container takes:
    np.load raises BadZipFile/EOFError/KeyError (not just OSError/
    ValueError) depending on WHERE the byte boundary falls."""
    try:
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile):
        return None


def request_resync(serving_dir: str, reason: str, **fields) -> Dict:
    """Ask the exporter to rebase: publish ``resync.json``. Idempotent —
    concurrent requesters just overwrite each other's identical ask; the
    exporter consumes whichever it sees at its next publish."""
    req = {"event": "resync_request", "reason": str(reason), **fields}
    write_json_atomic(os.path.join(serving_dir, RESYNC_REQUEST), req)
    return req


def read_resync_request(serving_dir: str) -> Optional[Dict]:
    return read_json(os.path.join(serving_dir, RESYNC_REQUEST))


def clear_resync_request(serving_dir: str) -> None:
    try:
        os.unlink(os.path.join(serving_dir, RESYNC_REQUEST))
    except OSError:
        pass
