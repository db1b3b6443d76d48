"""Multi-host runtime: initialization, sample-queue scaling, health checks.

Single-host multi-card runs need no process coordination (one process, all
local devices in the mesh).  Multi-process runs use `jax.distributed` —
initialize before device use, then build the global mesh; collectives
between the cards of one host ride NVLink and cross-host traffic rides the
network, so the mesh layout keeps the ``db`` axis (latency-sensitive psum)
inside a host and spreads ``data`` across hosts (SURVEY.md §5
distributed-comm row).

Because samples are fully independent (per-sample counter reset,
``newkmer_10nx.cpp:1015-1045``), the coarse-grained scale-out path is a
sample work queue: hosts claim samples via an atomic manifest, and the
fine-grained path (one sample spread over many chips) uses
ShardedClassifier.  A crash loses at most the in-flight sample (the
reference loses the whole batch).
"""

from __future__ import annotations

import json
import os
import socket
import time

import jax

from kmer_id_tpu.utils.logging import log


_LOOPBACK = ("localhost", "127.0.0.1", "[::1]")


def local_rank(coordinator: str | None, process_id: int | None) -> int | None:
    """The card index this process opens on its host, or None to leave the
    choice to JAX (and to a launcher's ``CUDA_VISIBLE_DEVICES``).

    In order: the launcher's ``LOCAL_RANK``; and, when the coordinator is a
    loopback address (every process on this host), the process id itself.
    Across hosts the process id says nothing about the card, and JAX's own
    cluster detection (SLURM, Open MPI) fills in the local rank where it
    can.  The card count cannot be asked here: any device query would bring
    up the backend before ``jax.distributed``.
    """
    if os.environ.get("LOCAL_RANK", "") != "":
        return int(os.environ["LOCAL_RANK"])
    host = (coordinator or "").rpartition(":")[0]
    if process_id is not None and host in _LOOPBACK:
        return process_id
    return None


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime (no-op when single-process).

    One process drives one card: each process opens only card
    :func:`local_rank` of its host (``local_device_ids``), so it neither
    reserves memory on its siblings' cards nor sees them as local devices.
    A launcher that pins cards itself through ``CUDA_VISIBLE_DEVICES`` (one
    card per process) is left to do so.
    """
    if num_processes is None or num_processes <= 1:
        return
    card = None
    if "CUDA_VISIBLE_DEVICES" not in os.environ:
        card = local_rank(coordinator, process_id)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=None if card is None else [card],
    )
    log(
        f"distributed up: process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )


def health_check(timeout_s: float = 60.0) -> dict:
    """Startup barrier + per-device sanity (failure-detection subsystem).

    Runs a tiny computation ON EVERY local device (a hung or sick
    non-default chip fails its own probe instead of hiding behind device 0)
    and, under multi-process ``jax.distributed``, a global psum across all
    processes acting as a startup barrier — a dead peer surfaces as this
    collective timing out rather than a later mid-batch hang.
    """
    import numpy as np

    import jax.numpy as jnp

    t0 = time.monotonic()
    per_device: dict[str, bool] = {}
    ok = True
    for d in jax.local_devices():
        try:
            v = jax.device_put(jnp.arange(8, dtype=jnp.int32), d).sum()
            good = int(v) == 28
        except Exception:
            good = False
        per_device[str(d)] = good
        ok &= good
    barrier_s = None
    if getattr(jax, "process_count", lambda: 1)() > 1:
        tb = time.monotonic()
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        devs = np.array(jax.devices())
        mesh = Mesh(devs, ("all",))
        x = jax.make_array_from_callback(
            (len(devs),), NamedSharding(mesh, P("all")),
            lambda idx: np.ones(np.zeros(len(devs))[idx].shape, np.int32),
        )
        total = int(
            jax.jit(
                jax.shard_map(
                    lambda v: jax.lax.psum(v.sum(), "all"),
                    mesh=mesh, in_specs=P("all"), out_specs=P(),
                )
            )(x)
        )
        ok &= total == len(devs)
        barrier_s = round(time.monotonic() - tb, 3)
    return {
        "host": socket.gethostname(),
        "process": getattr(jax, "process_index", lambda: 0)(),
        "devices": per_device,
        "ok": ok,
        "barrier_s": barrier_s,
        "probe_s": round(time.monotonic() - t0, 3),
    }


class SampleQueue:
    """File-locked work queue of independent samples (restartable)."""

    def __init__(self, manifest_path: str, samples: list[str]):
        self.path = manifest_path
        self.samples = samples
        if not os.path.exists(manifest_path):
            # take the lock: concurrent workers may race to create the
            # manifest (observed as a vanished .tmp under os.replace)
            lock = self.path + ".lock"
            for _ in range(100):
                try:
                    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    break
                except FileExistsError:
                    time.sleep(0.05)
            else:
                raise TimeoutError("manifest lock")
            try:
                if not os.path.exists(manifest_path):
                    self._write({"pending": samples, "done": [], "claimed": {}})
            finally:
                os.close(fd)
                os.unlink(lock)

    def _read(self) -> dict:
        with open(self.path) as f:
            return json.load(f)

    def _write(self, state: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, self.path)

    def claim(self, worker: str) -> str | None:
        """Claim the next pending sample (atomic via rename)."""
        lock = self.path + ".lock"
        for _ in range(100):
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                time.sleep(0.05)
        else:
            return None
        try:
            state = self._read()
            if not state["pending"]:
                return None
            sample = state["pending"].pop(0)
            state["claimed"][sample] = {"worker": worker, "t": time.time()}
            self._write(state)
            return sample
        finally:
            os.close(fd)
            os.unlink(lock)

    def complete(self, sample: str) -> None:
        lock = self.path + ".lock"
        for _ in range(100):
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                time.sleep(0.05)
        else:
            raise TimeoutError("manifest lock")
        try:
            state = self._read()
            state["claimed"].pop(sample, None)
            if sample not in state["done"]:
                state["done"].append(sample)
            self._write(state)
        finally:
            os.close(fd)
            os.unlink(lock)

    def reclaim_stale(self, timeout_s: float = 3600.0) -> list[str]:
        """Requeue samples whose worker went silent (elastic recovery)."""
        state = self._read()
        now = time.time()
        stale = [s for s, c in state["claimed"].items() if now - c["t"] > timeout_s]
        if stale:
            for s in stale:
                state["claimed"].pop(s)
                state["pending"].insert(0, s)
            self._write(state)
        return stale
