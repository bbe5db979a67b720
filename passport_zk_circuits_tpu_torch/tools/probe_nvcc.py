"""Run the K9 probe battery on the card and print PASS or FAIL for each
probe as it finishes.

Counterpart of ``tools/probe_mosaic.py``: that battery found what the
Pallas TPU compiler accepts; this one checks, probe by probe, what the
port's hand-written kernels rely on and what their redesigns will need
(``ops/cuda_probe.py`` lists them). Each probe runs alone, in a launch of
its own, so a hang names its probe; then the kernel probes among them run
together in one launch (``battery``). Every probe runs even after one
fails, and the command exits non-zero if any failed.

    python -m passport_zk_circuits_tpu_torch.tools.probe_nvcc \\
        [--device cuda] [probe ...]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops import cuda_probe


def run_all(device, names=None) -> dict:
    """{probe: None if it passed, else its error message}, printing as it
    goes; the key "battery" holds the kernel probes' one launch."""
    names = list(names or cuda_probe.PROBES)
    jobs = [(name, lambda name=name: cuda_probe.run(name, device))
            for name in names]
    in_battery = [name for name in names if name in cuda_probe.BATTERY]
    if in_battery:
        jobs.append(("battery", lambda: cuda_probe.run_battery(device,
                                                               in_battery)))
    results = {}
    for name, fn in jobs:
        t0 = time.perf_counter()
        print(f"PROBE {name} ...", flush=True)
        try:
            fn()
            results[name] = None
        except Exception as e:       # reported, and the run fails below
            results[name] = f"{type(e).__name__}: {e}".replace("\n", " | ")
        dt = time.perf_counter() - t0
        verdict = "PASS" if results[name] is None else "FAIL"
        print(f"{verdict}  {name}  ({dt:.2f}s)"
              + ("" if results[name] is None else f": {results[name][:300]}"),
              flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("probes", nargs="*", help="default: all of "
                    + ", ".join(cuda_probe.PROBES))
    args = ap.parse_args(argv)
    unknown = sorted(set(args.probes) - set(cuda_probe.PROBES))
    if unknown:
        ap.error(f"unknown probes {unknown}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("probe_nvcc: no CUDA device", file=sys.stderr)
        return 1
    failed = [n for n, err in run_all(dev, args.probes).items() if err]
    print(f"{len(failed)} probe(s) failed: {failed}" if failed
          else "all probes passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
