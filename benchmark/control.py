"""Read a cell's correctness numbers for the sound program, for its
control and for a planted fault, on the card, over several seeds in one
process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 8 \
        [--control 2] [--plant greedy|worst_beam]

For each seed the cell runs a short window at its own load and size; then
the served outputs are compared with the reference as a run compares them
("served"). On the first ``--control`` seeds (all by default) the reference
at one precision step below the configuration's (int4 for int8, fp8 for
bf16: "control") is put in the program's place and read in the same way.
``--plant`` runs the program with an ASR fault underneath the timed path:
every dispatch decoded at beam 1 ("greedy"), or the hypothesis its store
ranks last served ("worst_beam"). One JSON line per seed. The limits in
``configs/<name>.json`` (``check.limits``) are set from these readings:
above the largest sound reading, below the smallest control reading. The
benchmark's own runs never run the control or a plant.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.run import cell, execute, load_spec


def planted(kind: str):
    """An ASR fault underneath the timed path: (object, attribute, the
    replacement to set there)."""
    from wis_tpu_torch.runtime import engine

    if kind == "greedy":
        orig_run = engine.WhisperEngine._run_windows

        def greedy(self, loaded, windows, prompts, beam, *args, **kwargs):
            return orig_run(self, loaded, windows, prompts, 1, *args, **kwargs)

        return engine.WhisperEngine, "_run_windows", greedy
    if kind == "worst_beam":
        orig_unpack = engine.unpack_asr_result

        def worst(packed, beam, max_new):
            tokens, lengths, best, lang_idx, lang_prob = orig_unpack(packed, beam, max_new)
            return tokens, lengths, best * 0 + beam - 1, lang_idx, lang_prob

        return engine, "unpack_asr_result", worst
    raise SystemExit(f"no fault {kind!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=None,
                    help="read the control on the first N seeds (default: all)")
    ap.add_argument("--plant", default=None, help="greedy or worst_beam")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from wis_tpu_torch.device import resolve_device

    if args.plant:
        setattr(*planted(args.plant))
    device = resolve_device("cuda:0")
    c = cell(load_spec(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control is None else args.control
    for i, seed in enumerate(seeds):
        run, _, _ = execute(c, seed, args.seconds, False, device, checked=False)
        modes = ("served", "control") if i < n_control else ("served",)
        readings = run.system.check(modes)
        print(json.dumps({"seed": seed, "plant": args.plant, **readings,
                          "failed": sum(1 for r in run.requests if not r["ok"])}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
