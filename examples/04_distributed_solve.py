"""Distributed eigensolve over all visible devices (several GPUs, or a
simulated CPU mesh via XLA_FLAGS=--xla_force_host_platform_device_count=8)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import maxwell_tpu
from maxwell_tpu.problems import BrickCavity3D

res = maxwell_tpu.solve(
    BrickCavity3D(nx=8, ny=8, nz=8), nev=3, distributed=True,
    maxiter=80,
)
print(res)
