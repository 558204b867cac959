"""The kernel mode's joint trajectory against the JAX package's, by channel.

Runs the reference binary's joint golden, cube_chain_ss4, in the kernel
mode in the port and in the JAX package on the CPU (as
tests/test_torch_joint_golden.py does, ~1.5 min), saves both trajectories
([2, ticks + 1, W, K, 13]: port, JAX) to OUT.npy and prints one JSON line:
the largest |port - JAX| of positions, rotations, velocities and angular
velocities, and each engine's early-gate miss (over the first 10 ticks).
With --other, the same script's OUT.npy of another checkout, it also
prints the largest |port - other port| by channel.

    JAX_PLATFORMS=cpu python tests/joint_golden_deviation.py OUT.npy \
        [--root CHECKOUT] [--other OTHER.npy]

--root is the checkout whose port and tests are imported (by default the
one holding this script).
"""

import argparse
import json
import os
import sys

import numpy as np

CHANNELS = {"pos": slice(0, 3), "rot": slice(3, 7), "v": slice(7, 10), "w": slice(10, 13)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--other")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    os.chdir(root)
    from test_torch_joint_golden import run_jax
    from test_torch_physics_golden import load_golden, run_equivalent

    golden, W, K, ss, dt = load_golden("cube_chain_ss4")
    T = golden.shape[0] - 1
    mine = run_equivalent(golden, W, K, ss, dt, T, "pallas", joint=True)
    theirs = run_jax(golden, W, K, ss, dt, T, "pallas")
    np.save(args.out, np.stack([mine, theirs]))

    def miss(x):
        return float(np.abs(x[..., 0:3] - golden[..., 0:3]).max(axis=(1, 2, 3))[:10].max())
    line = {"root": root, "ticks": T,
            "port_vs_jax": {k: float(np.abs(mine[..., s] - theirs[..., s]).max())
                            for k, s in CHANNELS.items()},
            "early_gate_miss": {"port": miss(mine), "jax": miss(theirs)}}
    if args.other:
        other = np.load(args.other)[0]
        line["port_vs_other"] = {k: float(np.abs(mine[..., s] - other[..., s]).max())
                                 for k, s in CHANNELS.items()}
    print(json.dumps(line))


if __name__ == "__main__":
    main()
