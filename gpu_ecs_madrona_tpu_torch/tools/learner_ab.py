#!/usr/bin/env python3
"""Times the PPO train step of one or more checkouts on one card, in turns:
an A/B of a change to the learner against its parent.

    python3 gpu_ecs_madrona_tpu_torch/tools/learner_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository; each runs in a
process of its own (so that two versions of the package never meet), in
the order given: "parent change change parent" is the usual A/B.  Each
prints one JSON line:

  ppo    ROOT's chip_smoke.py ``main_ppo_fantasy_vs`` (fantasy_vs at 16384
         worlds x (50 + 200), cleanup on, 2 epochs, 2 minibatches,
         observation normalisation): the timed train steps' wall seconds,
         training env-steps/s (median, min, max), the rollout's and the
         update's device ms, the peak of allocated memory over the start
  rows   the policy's results at main_ppo_fantasy_vs's widths (obs 1250,
         hidden 128, actions 600): for ``policy_apply``, 4096 rows
         against the same rows in two calls of 2048 (how 2 ranks of 2048
         worlds see them); where ROOT has ``policy_rows``, 65536 rows
         against parts of 2048 to 32768 of them and against one batched
         product of a single 4096-row block (the largest difference of mu
         and of the value), and the device ms of one call of each at
         16384 rows (median of 3 windows of 50 calls)

The script needs a CUDA card; without one it exits 1 and prints nothing.
"""

import json
import os
import subprocess
import sys

ROWS = 4096


def rows_case(torch, pl):
    """The largest differences of mu and value between a call on many rows
    and calls on parts of them, and the device ms of a call."""
    cfg = pl.PPOConfig(obs_dim=1250, act_dim=600)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = pl.init_params(cfg, g)
    obs = torch.randn((16 * ROWS, 1250), generator=g, device="cuda")

    def differences(f, whole, parts):
        out = {}
        for lo, hi in parts:
            part = f(params, obs[lo:hi])
            out[f"{lo}:{hi}"] = {k: float((part[i] - whole[i][lo:hi]).abs().max())
                                 for i, k in ((0, "mu"), (2, "value"))}
        return out

    def ms(f, x, iters=50):
        for _ in range(5):
            f(params, x)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        times = []
        for _ in range(3):
            ev[0].record()
            for _ in range(iters):
                f(params, x)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]) / iters)
        return sorted(times)[1]

    half = ROWS // 2
    out = {"policy_apply": differences(pl.policy_apply, pl.policy_apply(params, obs[:ROWS]),
                                       ((0, half), (half, ROWS)))}
    out["policy_apply_ms_16384"] = ms(pl.policy_apply, obs[:4 * ROWS])
    f = getattr(pl, "policy_rows", None)
    if f is None:
        out["policy_rows"] = "absent"
        return out
    whole = f(params, obs)
    out["policy_rows"] = differences(f, whole, (
        (0, half), (half, ROWS), (0, ROWS), (0, 2 * ROWS), (3000, 9000),
        (ROWS, 4 * ROWS), (0, 8 * ROWS)))
    # why policy_rows takes two blocks or more: one batched block's product
    one = pl.policy_apply(params, obs[None, :ROWS])
    out["one_block_bmm"] = {k: float((one[i][0] - whole[i][:ROWS]).abs().max())
                            for i, k in ((0, "mu"), (2, "value"))}
    out["policy_rows_ms_16384"] = ms(f, obs[:4 * ROWS])
    return out


def one(root):
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke
    from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
    from gpu_ecs_madrona_tpu_torch.parallel import learner as pl
    if not os.path.dirname(os.path.abspath(pl.__file__)).startswith(root):
        raise RuntimeError(f"the package came from {pl.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    line = chip_smoke.main_ppo_fantasy_vs(torch, fvs, pl, chip_smoke.nvidia_smi_line(),
                                          lambda: None, lambda: {})
    keys = ("step_s", "env_steps_per_s", "rollout_device_ms", "update_device_ms",
            "peak_over_start_gib")
    print(json.dumps({"root": root, "ppo": {k: line[k] for k in keys},
                      "rows": rows_case(torch, pl)}), flush=True)


def main(argv):
    if "--one" in argv:
        one(argv[argv.index("--one") + 1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("learner_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = [a for a in argv if not a.startswith("--")]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip().splitlines()[0], "order": roots}), flush=True)
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
