"""Fault-tolerant restart supervisor (a copy of ``repro.launch.supervisor``,
which imports no JAX; the port keeps its own).

Wraps any launch command; on non-zero exit it restarts with exponential
backoff, relying on the atomic-manifest checkpoints for exactly-resumable
state. At cluster scale one supervisor runs per host; a missing heartbeat
(the straggler watchdog in ``train.loop``) or a hardware fault kills the
process and this loop brings it back from the last durable step.

  PYTHONPATH=src python -m repro_torch.launch.supervisor --max-restarts 3 -- \\
      python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 50 \\
      --ckpt-dir ckpt --device cpu
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time


def supervise(cmd, max_restarts=5, backoff=2.0, log=print):
    attempt = 0
    while True:
        t0 = time.time()
        log(f"[supervisor] attempt {attempt}: {' '.join(cmd)}")
        proc = subprocess.run(cmd)
        if proc.returncode == 0:
            log("[supervisor] clean exit")
            return 0
        attempt += 1
        if attempt > max_restarts:
            log(f"[supervisor] giving up after {max_restarts} restarts")
            return proc.returncode
        delay = min(backoff**attempt, 60.0)
        log(f"[supervisor] exit={proc.returncode} after {time.time()-t0:.0f}s; restart in {delay:.0f}s")
        time.sleep(delay)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        raise SystemExit("usage: supervisor [--max-restarts N] -- <command...>")
    sys.exit(supervise(cmd, args.max_restarts))


if __name__ == "__main__":
    main()
