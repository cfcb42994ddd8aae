"""Multi-device scaling: shard a simulation over a device mesh.

Runs on any host — it creates 8 virtual CPU devices, which is exactly
how the test suite validates the sharded paths (SURVEY.md §4.4). On a
multi-GPU host, drop the virtual-device setup and the same code shards
over the cards (``chip_smoke.py --four-gpus`` does so on four).

    python examples/sharded_run.py            # 8 virtual CPU devices
    python examples/sharded_run.py --mesh 4x2 # 2-D (X×Y) decomposition
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

parser = argparse.ArgumentParser()
parser.add_argument("--devices", type=int, default=8)
parser.add_argument("--mesh", type=str, default="",
                    help="NXxNY for 2-D decomposition (GSPMD route)")
parser.add_argument("--res", type=int, default=128)
parser.add_argument("--steps", type=int, default=50)
args = parser.parse_args()

# Virtual devices for hosts without several cards; must be set before jax
# initializes a backend. (On a real multi-GPU host, delete these lines.)
flags = os.environ.get("XLA_FLAGS", "")
if "device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={args.devices}"
    ).strip()
else:
    print(f"note: XLA_FLAGS already sets a device count — it wins over "
          f"--devices {args.devices}")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from fluid2d_tpu import FluidSimulator
from fluid2d_tpu.parallel.sharding import shard_simulator

sim = FluidSimulator.create(bc_num=2, resolution=args.res, scheme="cip")

if args.mesh:
    nx, ny = (int(v) for v in args.mesh.lower().split("x"))
    mesh = shard_simulator(sim, mesh_shape=(nx, ny))
else:
    # 1-D X decomposition; routes through the explicit ghost-window
    # halo-exchange path (ONE lax.ppermute per step) when the slabs are
    # wide enough, else GSPMD.
    mesh = shard_simulator(sim, args.devices)

print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}, "
      f"path: {sim.shard_path}")
print("state sharding:", sim.state.v.sharding)

t0 = time.perf_counter()
sim.step(args.steps)
rate = args.steps / (time.perf_counter() - t0)
print(f"{args.steps} steps at res={args.res}: {rate:.1f} steps/s "
      f"(virtual CPU devices — for correctness, not speed)")
print("max |v|:", float(np.abs(np.asarray(sim.state.v)).max()))
