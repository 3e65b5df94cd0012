"""Multi-host distribution: jax.distributed init + host-aware meshes.

The reference has no distributed layer to port (SURVEY §2.9) — this is the
framework's own scale-out design.  One process per host; each process owns
its local cards.  Batch work shards two ways:

- **compute**: a global ``Mesh`` over every card in the job.  Within a host
  the cards talk over NVLink; across hosts over the network, so the 2-D
  ``slice_mesh`` puts the outer ('hosts') axis across processes and the
  inner ('local') axis over each process's local cards.  Pure batch
  parallelism only needs the flat 1-D mesh; spatial halo exchange
  (parallel.spatial) should stay on the 'local' axis of the 2-D mesh.
- **I/O**: globbing/decode/encode are per-host; `shard_inputs` deals each
  host a deterministic slice of the input list so hosts never touch the
  same file.

Wire-up is env-driven so the CLI works unchanged on one host and under a
launcher: PAINTFE_COORDINATOR (host:port), PAINTFE_NUM_PROCESSES,
PAINTFE_PROCESS_ID — or the standard cluster auto-detection built into
``jax.distributed.initialize`` (SLURM and other cluster launchers).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh


def maybe_initialize(verbose: bool = False) -> bool:
    """Initialize jax.distributed when a multi-process launch is requested.

    Returns True when running as part of a multi-process job (after
    initialization), False for plain single-process runs.  Safe to call
    more than once.
    """
    try:
        from jax._src import distributed as _dist

        if getattr(_dist.global_state, "client", None) is not None:
            return True  # this process already joined a distributed job
    except ImportError:
        pass
    coord = os.environ.get("PAINTFE_COORDINATOR")
    nproc = os.environ.get("PAINTFE_NUM_PROCESSES")
    pid = os.environ.get("PAINTFE_PROCESS_ID")
    if (coord or nproc or pid) and not (coord and nproc and pid):
        # Partial wiring is a launcher bug: silently degrading to N
        # independent single-process runs makes every host process the
        # full input list and race on the same output files.
        missing = [n for n, v in (("PAINTFE_COORDINATOR", coord),
                                  ("PAINTFE_NUM_PROCESSES", nproc),
                                  ("PAINTFE_PROCESS_ID", pid)) if not v]
        raise RuntimeError(
            "partial multi-process wiring: missing " + ", ".join(missing))
    if not coord:
        # no explicit wiring: multi-process only when the environment
        # (a cluster launcher's auto-init) already set one up.  NB this may
        # initialize the backend — fine, because without the env vars we
        # were never going to call jax.distributed.initialize ourselves.
        return jax.process_count() > 1
    try:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(pid),
        )
    except RuntimeError as e:
        msg = str(e).lower()
        if "already" not in msg and "once" not in msg:
            raise  # genuinely failed (bad address, backend already up, ...)
    if verbose:
        print(
            f"[distributed] process {jax.process_index()}/{jax.process_count()}"
            f" with {jax.local_device_count()} local"
            f" / {jax.device_count()} global devices"
        )
    return True


def global_batch_mesh() -> Mesh:
    """Flat 1-D mesh over every device in the job, axis 'batch'."""
    return Mesh(np.array(jax.devices()), ("batch",))


def slice_mesh() -> Mesh:
    """2-D ('hosts', 'local') mesh: processes on the outer axis, each
    process's local devices on the inner axis.

    Shardings that communicate per step (halo exchange, reductions) should
    map to 'local'; 'hosts' should only carry batch-level scatter/gather,
    since links inside a host are much faster than the network between
    hosts.
    """
    procs = jax.process_count()
    local = jax.local_device_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    grid = np.array(devs).reshape(procs, local)
    return Mesh(grid, ("hosts", "local"))


def shard_inputs(inputs: Sequence, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> List:
    """Deterministic per-host slice of a work list (round-robin).

    Round-robin (rather than contiguous blocks) keeps the load even when
    input sizes correlate with their position in the glob order.
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return list(inputs)[pi::pc]


def all_processes_ok(local_ok: bool) -> bool:
    """Cross-process AND of per-host success flags (for exit codes).

    Every host learns whether any peer failed, so all processes exit with
    the same code; on a single process this is just `local_ok`.
    """
    if jax.process_count() == 1:
        return bool(local_ok)
    from jax.experimental import multihost_utils

    flags = multihost_utils.process_allgather(
        np.array([0.0 if local_ok else 1.0], np.float32)
    )
    return float(np.sum(flags)) == 0.0
