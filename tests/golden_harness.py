"""Golden-test harness: compile and run the reference C++ for comparison.

The reference sources are compiled *at test time* into a gitignored cache,
with only their memory-size constants reduced (MAXHASH 2^35→2^26 for the
builder, 2^30→2^22 for classifiers) so the fixtures fit CI memory — the same
memory-only tweak used for the verified run in SURVEY.md §8.  Nothing from
the reference enters the framework; these binaries exist purely to produce
golden outputs that kmer_id_tpu must match byte-for-byte.
"""

from __future__ import annotations

import gzip
import os
import shutil
import subprocess

import numpy as np

REF_DIR = "/root/reference"
CACHE = os.path.join(os.path.dirname(__file__), ".cache")


def _compile(src_name: str, out_name: str, subs: list[tuple[str, str]]) -> str | None:
    """Copy a reference source, apply constant substitutions, compile."""
    os.makedirs(CACHE, exist_ok=True)
    out = os.path.join(CACHE, out_name)
    src_path = os.path.join(REF_DIR, src_name)
    if not os.path.exists(src_path) or shutil.which("g++") is None:
        return None
    if os.path.exists(out) and os.path.getmtime(out) > os.path.getmtime(src_path):
        return out
    with open(src_path) as f:
        code = f.read()
    for old, new in subs:
        if old not in code:
            raise RuntimeError(f"substitution target not found in {src_name}: {old}")
        code = code.replace(old, new)
    tweaked = os.path.join(CACHE, out_name + ".cpp")
    with open(tweaked, "w") as f:
        f.write(code)
    r = subprocess.run(
        ["g++", "-O2", "-std=c++11", tweaked, "-o", out, "-lz"],
        capture_output=True,
        text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {src_name}:\n{r.stderr[-2000:]}")
    return out


def build_binary() -> str | None:
    return _compile(
        "kmer_build_vf6.cpp",
        "ref_build",
        [("const ktype MAXHASH = (1LL << 35);", "const ktype MAXHASH = (1LL << 26);")],
    )


def classifier_vf6_binary() -> str | None:
    return _compile(
        "kmer_read_vf6.cpp",
        "ref_read_vf6",
        [("const itype MAXHASH = (1 << 30);", "const itype MAXHASH = (1 << 22);")],
    )


def classifier_m3_binary() -> str | None:
    return _compile(
        "kmer_read_m3.cpp",
        "ref_read_m3",
        [("const itype MAXHASH = (1 << 30);", "const itype MAXHASH = (1 << 22);")],
    )


def murmur_fmix64(k: np.ndarray) -> np.ndarray:
    """MurmurHash3 finalizer (the reference's integerHash) for collision checks."""
    k = np.asarray(k, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xFF51AFD7ED558CCD)
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xC4CEB9FE1A85EC53)
        k ^= k >> np.uint64(33)
    return k


def assert_no_builder_collisions(keys: np.ndarray, maxhash_log2: int = 26) -> None:
    """The reference builder table is keyless: a collision would make the
    golden comparison diverge by design, so fixtures must avoid them."""
    idx = murmur_fmix64(keys) & np.uint64((1 << maxhash_log2) - 1)
    assert len(np.unique(idx)) == len(np.unique(keys)), (
        "fixture keys collide in the reference's 2^%d table; reseed fixture"
        % maxhash_log2
    )


def gzip_file(src: str, dst: str) -> None:
    with open(src, "rb") as fi, gzip.open(dst, "wb") as fo:
        shutil.copyfileobj(fi, fo)


def _proc_snapshot(pid: int) -> str:
    """Capture WHERE a wedged child is blocked (state, wait channel, current
    syscall, and per-thread kernel stacks when readable) before it is killed
    — a diagnostic in place of blind retries.
    Every observed wedge so far printed all its progress output first, so the
    snapshot of the post-output blocking point is the root-cause artifact."""
    out = []
    for name in ("stat", "wchan", "syscall", "status"):
        try:
            with open(f"/proc/{pid}/{name}") as f:
                data = f.read(2000).strip()
            if name == "status":
                data = " ".join(
                    ln for ln in data.splitlines()
                    if ln.split(":")[0] in ("State", "Threads", "VmRSS")
                )
            out.append(f"{name}={data!r}")
        except OSError as e:
            out.append(f"{name}=<{e.__class__.__name__}>")
    try:
        for tid in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{tid}/stack") as f:
                out.append(f"stack[{tid}]={f.read(2000).strip()!r}")
    except OSError:
        pass  # kernel stacks often need root; the syscall line still lands
    return "; ".join(out)


def run(binary: str, args: list[str], cwd: str, timeout: int = 120,
        retries: int = 2) -> subprocess.CompletedProcess:
    """Run a reference binary; on timeout, snapshot /proc, kill, retry.

    Compiled golden binaries intermittently wedge AFTER printing ALL their
    progress output (observed twice across full-suite runs, under host CPU
    saturation; the same fixture passes in seconds in isolation).  Policy:
    healthy fixtures complete in seconds, so early attempts use a short
    timeout, but the FINAL attempt falls back to a 600 s budget so a
    legitimately slow run on a loaded host still passes.  Each timed-out attempt prints the child's /proc blocking-point
    snapshot (_proc_snapshot) plus its output tail, so any recurrence
    arrives with the syscall it was stuck in; retry counts are surfaced in
    the printed lines.
    """
    last = None
    for attempt in range(retries + 1):
        tmo = max(timeout, 600) if attempt == retries else timeout
        proc = subprocess.Popen(
            [binary] + args, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        try:
            stdout, stderr = proc.communicate(timeout=tmo)
            return subprocess.CompletedProcess(
                [binary] + args, proc.returncode, stdout, stderr
            )
        except subprocess.TimeoutExpired as e:
            snap = _proc_snapshot(proc.pid)
            proc.kill()
            stdout, stderr = proc.communicate()
            last = subprocess.TimeoutExpired(
                [binary] + args, tmo, output=stdout, stderr=stderr
            )
            print(
                f"[golden] {binary} timed out after {tmo}s "
                f"(attempt {attempt + 1}/{retries + 1}); proc: {snap}; "
                f"stdout tail: {(stdout or '')[-300:]!r}",
                flush=True,
            )
    raise last
