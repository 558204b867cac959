"""Closed-loop exec-config autotuner (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/tooling/autotuner.py`` (reference
scripts/profile.py sweeps, consumed through MADRONA_MWGPU_EXEC_CONFIG_FILE,
src/mw/cuda_exec.cpp:1460-1517).  The tunables are the collisions kernel on
or off, the physics contact mode ("dense", "pairs", "pallas") and the
rigid-body candidate capacity; the consumers are the "auto" paths:

  * ``tune_*`` measure candidate configs, each in a fresh process on the
    given device, and return artifact entries; ``save`` writes them to a
    JSON file.
  * Set GEM_TPU_EXEC_CONFIG_FILE=<path> (or keep ./gem_tune.json) and
    ``CollisionsConfig(fused=None)``, ``setup_substep_tasks(contact_mode=
    "auto")`` and ``RigidBenchConfig.candidates()`` take the nearest
    tuned workload before their fixed rule.

An entry is keyed by the backend it was measured on: "cuda" on the card,
"cpu" otherwise.  ``lookup`` takes only entries of the caller's backend,
so the JAX package's entries ("tpu") are never read here.  Nearest-
workload matching is a log-space distance over the numeric key fields.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

CONFIG_ENV = "GEM_TPU_EXEC_CONFIG_FILE"
DEFAULT_PATH = "gem_tune.json"
MEASURE_TIMEOUT_S = 1800

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_cache: Dict[str, Any] = {"path": None, "mtime": None, "artifact": None}


def backend() -> str:
    """The port's backend: "cuda" with a card, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def config_path() -> Optional[str]:
    p = os.environ.get(CONFIG_ENV)
    if p:
        return p
    if os.path.exists(DEFAULT_PATH):
        return DEFAULT_PATH
    return None


def load(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Load (and mtime-cache) the exec-config artifact; None if absent."""
    path = path or config_path()
    if not path or not os.path.exists(path):
        return None
    mtime = os.path.getmtime(path)
    if _cache["path"] == path and _cache["mtime"] == mtime:
        return _cache["artifact"]
    with open(path) as f:
        artifact = json.load(f)
    _cache.update(path=path, mtime=mtime, artifact=artifact)
    return artifact


def lookup(kind: str, path: Optional[str] = None, backend_name: Optional[str] = None,
           **key) -> Optional[Dict[str, Any]]:
    """Nearest tuned config for ``kind`` at this workload key, or None.

    Matches in log space over the numeric key fields both sides have; an
    entry with no shared field matches at distance 0.  Trust gates, as in
    the JAX package: an entry is ignored unless it was measured on the
    caller's backend (``backend_name``, default ``backend()``: a consumer
    on a device passes its device's type) and carries ``validated: true``,
    which ``tune_*`` set only when the winner, measured again in a fresh
    process, is within 1.5x of the fixed rule's config.
    """
    artifact = load(path)
    if not artifact:
        return None
    want = backend_name or backend()
    best, best_d = None, None
    for entry in artifact.get("entries", []):
        if entry.get("kind") != kind or entry.get("backend") != want:
            continue
        if not entry.get("validated"):
            continue
        ek = entry.get("key", {})
        d = 0.0
        for k, v in key.items():
            if k in ek and isinstance(v, (int, float)) and v > 0 \
                    and isinstance(ek[k], (int, float)) and ek[k] > 0:
                d += (math.log(float(v)) - math.log(float(ek[k]))) ** 2
        if best_d is None or d < best_d:
            best, best_d = entry, d
    return dict(best["config"]) if best else None


def save(entries: List[Dict[str, Any]], path: Optional[str] = None) -> str:
    """Write ``entries`` into the artifact at ``path`` (default: the
    environment's, else ./gem_tune.json), replacing entries of the same
    kind and key."""
    path = path or os.environ.get(CONFIG_ENV) or DEFAULT_PATH
    artifact = load(path) or {"entries": []}

    def sig(e):
        return (e.get("kind"), tuple(sorted(e.get("key", {}).items())))

    new = {sig(n) for n in entries}
    artifact["entries"] = [e for e in artifact["entries"] if sig(e) not in new] + entries
    with open(path, "w") as f:
        json.dump(artifact, f, indent=2)
    _cache["mtime"] = None  # invalidate
    return path


# ---------------------------------------------------------------------------
# Tuners: measure candidate configs.
# ---------------------------------------------------------------------------


def _time_executor(sim, ticks: int) -> float:
    """env-steps/s of a built executor (3 warm-up steps excluded).  The
    window ends with ``block_until_ready`` (a synchronise on the card) and
    a value fetched to the host."""
    def drain():
        leaf = sim.state["tick"]
        leaf.reshape(-1)[0].item()

    sim.run(3)
    sim.block_until_ready()
    drain()
    t0 = time.perf_counter()
    sim.run(ticks)
    sim.block_until_ready()
    drain()
    return ticks * sim.cfg.num_worlds / (time.perf_counter() - t0)


_MEASURE_SNIPPET = """\
import json
{env}from gpu_ecs_madrona_tpu_torch.tooling.autotuner import _time_executor
{build}
print("TUNE_RESULT " + json.dumps(_time_executor(sim, {ticks})))
"""


def _run_child(code: str, timeout: float):
    """``code`` in a fresh Python with the checkout on its path: the
    TUNE_RESULT it printed, parsed; raises if it failed or timed out."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=timeout, env=env)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"tuner subprocess timed out after {timeout} s") from e
    for line in r.stdout.splitlines():
        if line.startswith("TUNE_RESULT "):
            return json.loads(line[len("TUNE_RESULT "):])
    raise RuntimeError(f"tuner subprocess failed (rc={r.returncode}): {r.stderr[-500:]}")


def _measure_subprocess(build: str, ticks: int, timeout: float,
                        artifact: Optional[str] = None) -> float:
    """Build and time an executor (``build`` binds ``sim``) in a fresh
    process.  Measurements are process-isolated, as in the JAX package: a
    config measured after another in one process inherits its state (the
    caching allocator's pool, built kernels and launch counters, host
    caches), so each candidate starts clean.  ``artifact``: the child's
    GEM_TPU_EXEC_CONFIG_FILE (the fixed rule's run points it at a file
    that does not exist)."""
    env = "" if artifact is None else (
        f"import os; os.environ[{CONFIG_ENV!r}] = {artifact!r}\n")
    return float(_run_child(_MEASURE_SNIPPET.format(env=env, build=build, ticks=ticks),
                            timeout))


def _heuristic(build: str, ticks: int, timeout: float) -> float:
    """env-steps/s of the fixed rule (no artifact visible), 0.0 if that run
    failed."""
    with tempfile.TemporaryDirectory() as d:
        try:
            return _measure_subprocess(build, ticks, timeout,
                                       artifact=os.path.join(d, "no_artifact.json"))
        except RuntimeError:
            return 0.0


def _finalize_entry(kind: str, key: Dict[str, Any], config: Dict[str, Any],
                    results: Dict[Any, float], best: Any, heuristic_speed: float,
                    revalidate_build: str, ticks: int, device: str,
                    failed: Dict[Any, str], timeout: float,
                    tolerance: float = 1.5) -> Dict[str, Any]:
    """Gate a sweep result before it can be persisted: the winner is
    measured again in one more fresh process and the entry records the
    lesser of its two speeds; ``validated`` only if that is within
    ``tolerance`` of the fixed rule's measured speed (a failed fixed-rule
    or recheck run fails validation).  Failed candidates are listed under
    ``failed``, never as winners."""
    try:
        recheck = _measure_subprocess(revalidate_build, ticks, timeout)
    except RuntimeError:
        recheck = 0.0
    confirmed = min(results[best], recheck)
    validated = (heuristic_speed > 0.0 and recheck > 0.0
                 and confirmed * tolerance >= heuristic_speed)
    return {
        "kind": kind,
        "key": key,
        "config": config,
        "backend": torch.device(device).type,
        "validated": bool(validated),
        "metric_steps_per_s": {str(k): round(v, 1) for k, v in results.items()},
        "failed": {str(k): v for k, v in failed.items()},
        "winner_recheck_steps_per_s": round(recheck, 1),
        "heuristic_steps_per_s": round(heuristic_speed, 1),
    }


def _sweep(candidates, build, ticks, timeout):
    """({candidate: env-steps/s}, {candidate: why it failed})."""
    results, failed = {}, {}
    for c in candidates:
        try:
            results[c] = _measure_subprocess(build(c), ticks, timeout)
        except RuntimeError as e:
            failed[c] = str(e)[-300:]
    return results, failed


def tune_collisions(num_worlds: int, num_objects: int = 100, ticks: int = 20,
                    device: str = "cuda",
                    timeout: float = MEASURE_TIMEOUT_S) -> Dict[str, Any]:
    """Sweep the collisions tick kernel on/off (``fused``) on ``device``, the
    unfused tick with the collision_pushes kernel (``use_kernel=True``):
    one process a config (each given ``timeout`` seconds), the winner
    checked against ``fused=None``'s fixed rule (see ``_finalize_entry``).
    The entry's config holds both fields as measured, and
    ``CollisionsConfig(fused=None)`` applies both."""
    def build(fused):
        return ("from gpu_ecs_madrona_tpu_torch.models import collisions as col\n"
                f"sim = col.make_executor(col.CollisionsConfig(num_worlds={num_worlds}, "
                f"num_objects={num_objects}, fused={fused}, use_kernel=True), "
                f"device={device!r})")

    results, failed = _sweep((False, True), build, ticks, timeout)
    if not results:
        raise RuntimeError(f"no collisions config ran: {failed}")
    heuristic = _heuristic(build(None), ticks, timeout)
    best = max(results, key=results.get)
    return _finalize_entry("collisions", {"num_worlds": num_worlds, "num_objects": num_objects},
                           {"fused": bool(best), "use_kernel": True}, results, best, heuristic,
                           build(best), ticks,
                           device, failed, timeout)


def tune_physics_substep(num_worlds: int, bodies: int = 64, ticks: int = 10,
                         modes=("dense", "pairs", "pallas"), device: str = "cuda",
                         timeout: float = MEASURE_TIMEOUT_S) -> Dict[str, Any]:
    """Sweep the physics contact mode on a rigid_bench workload, one
    process a mode.  No ``substep_wt``: the port runs one CTA a world."""
    def build(mode):
        return ("from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb\n"
                f"sim = rb.make_executor(rb.RigidBenchConfig(num_worlds={num_worlds}, "
                f"num_bodies={bodies}, contact_mode={mode!r}), device={device!r})")

    results, failed = _sweep(modes, build, ticks, timeout)
    if not results:
        raise RuntimeError(f"no physics config ran: {failed}")
    heuristic = _heuristic(build("auto"), ticks, timeout)
    best = max(results, key=results.get)
    return _finalize_entry("physics_substep", {"num_worlds": num_worlds, "bodies": bodies},
                           {"contact_mode": best}, results, best, heuristic, build(best),
                           ticks, device, failed, timeout)


_CAPACITY_VALIDATE_SNIPPET = """\
import json
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
sim = rb.make_executor(rb.RigidBenchConfig(
    num_worlds={vw}, num_bodies={bodies}, contact_mode="pallas",
    max_candidates={cands}, contact_refresh=True, seed=0), device={device!r})
sim.run({vticks})
sim.block_until_ready()
ov = int(sum(int(v.sum()) for v in sim.overflow_counters().values()))
pos, mask = sim.get_exported(0)
finite = bool(pos[mask].isfinite().all())
print("TUNE_RESULT " + json.dumps({{"overflow": ov, "finite": finite}}))
"""


def tune_physics_capacity(num_worlds: int, bodies: int = 64, ticks: int = 20,
                          validate_ticks: int = 250, device: str = "cuda",
                          timeout: float = MEASURE_TIMEOUT_S) -> Dict[str, Any]:
    """Sweep the candidate capacity (``max_candidates``) of the rigid-body
    workload.  A capacity may win only if a long run (``validate_ticks``
    through the pile's formation, at up to 2048 worlds) in a fresh
    process drops no candidate and keeps finite positions; consumers take
    it only at an exact ``bodies`` match."""
    def build(cands):
        return ("from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb\n"
                f"sim = rb.make_executor(rb.RigidBenchConfig(num_worlds={num_worlds}, "
                f"num_bodies={bodies}, contact_mode='pallas', contact_refresh=True, "
                f"max_candidates={cands}), device={device!r})")

    def overflow_clean(cands) -> bool:
        code = _CAPACITY_VALIDATE_SNIPPET.format(vw=min(num_worlds, 2048), bodies=bodies,
                                                 cands=cands, vticks=validate_ticks,
                                                 device=device)
        try:
            d = _run_child(code, timeout)
        except RuntimeError:
            return False
        return d["overflow"] == 0 and d["finite"]

    default_k = 4 * bodies
    cand_ks = sorted({max(128, k) for k in (default_k // 2, (3 * default_k) // 4, default_k)})
    results, failed = _sweep(cand_ks, build, ticks, timeout)
    if not results:
        raise RuntimeError(f"no capacity config ran: {failed}")
    clean = {k: k == default_k or overflow_clean(k) for k in results}
    eligible = {k: v for k, v in results.items() if clean[k]} or results
    best = max(eligible, key=eligible.get)
    heuristic = _heuristic(build(0), ticks, timeout)
    entry = _finalize_entry("physics_capacity", {"num_worlds": num_worlds, "bodies": bodies},
                            {"max_candidates": int(best), "for_bodies": int(bodies)},
                            results, best, heuristic, build(best), ticks, device, failed,
                            timeout)
    entry["overflow_clean"] = {str(k): bool(v) for k, v in clean.items()}
    if not clean[best]:     # a capacity that dropped pairs is never consumed
        entry["validated"] = False
    return entry
