"""Check that mip.solve keeps its time limit on one battery instance.

Usage: python scripts/repro_deadline.py [time_limit_sec] [instance_name]
"""
import sys
import time

import numpy as np

from ortools_tpu.mip.branch_and_bound import solve as mip_solve
from ortools_tpu.models.mip_generators import miplib_like_battery
from ortools_tpu.utils.device import enable_compile_cache

enable_compile_cache()

tlim = float(sys.argv[1]) if len(sys.argv) > 1 else 90.0
name = sys.argv[2] if len(sys.argv) > 2 else "edge_packing_300_s15"

battery = miplib_like_battery(scale=1.0)
qp = next(q for q in battery if q.name == name)
t0 = time.perf_counter()
r = mip_solve(qp, max_nodes=20_000, node_batch_size=64,
              time_limit_sec=tlim)
dt = time.perf_counter() - t0
print(f"{name}: status={r.status.name} obj={r.objective_value} "
      f"nodes={r.num_nodes} wall={dt:.1f}s limit={tlim}s "
      f"overrun={dt/tlim:.2f}x")
