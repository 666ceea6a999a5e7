"""What cuDNN's benchmark mode costs per new edit in the PyTorch port, for
each setting of the engine's ``benchmark_limit`` (how many of cuDNN's
algorithms benchmark mode times for each new conv shape; PyTorch's
default is 10, the engine's is ``sige_torch.nn.engine.BENCHMARK_LIMIT``).

    python3 scripts/retime_cost.py [--limit N] [--paths ddpm sd gaugan]
    python3 scripts/retime_cost.py --repeat 3 --limits 1 2 3 10 \\
        [--paths ...] [--out chiprun_out/retime_runs.jsonl]

The engine runs every forward in benchmark mode, and cuDNN keeps what it
timed for the life of the process, so one process measures one setting.
It times, in this order, with the host clock around each call
(synchronised):

  * the church256 DDPM main path (``DiffusionRunner``, layout auto, DDIM,
    5 steps from noise level 500): ``generate`` on the edit of
    ``chip_smoke.py``, again, on its second edit (other window shapes at
    every level), again;
  * the SD path of ``chip_smoke.py`` (``SDRunner`` at 512^2, guidance
    7.5, 10 DDIM steps at strength 0.5): ``sdedit`` on the same two edits
    in the same order; then the decoder's full and sparse forward over
    the last edit's plan (median of 20 between CUDA events, and the peak
    MB of one);
  * the GauGAN path of ``chip_smoke.py`` (``GauGANRunner`` with the
    Cityscapes SPADE generator at 512x256, layout auto): ``generate`` on
    its synthetic edit, again, on its second edit, again.

Each process prints one JSON line, with the limit in force inside a
forward (read by a forward hook).

With ``--repeat R`` the script instead starts R x len(limits) such
processes one after another, the settings interleaved (each round runs
every limit, the order rotated by one per round, so that the host's
drift falls on all of them alike), writes each process's line to
``--out``, and prints a summary per limit and the limit that the rule
picks: among the limits for which every run keeps the SD decoder's
sparse forward below its full forward with a peak under 10 GB, the one
with the lowest new-edit cost (second edit minus its repeat, SD plus
DDPM; median over the runs); where another limit's range of costs
overlaps the best one's, the smallest such limit.

GPU only: exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (SD_GUIDANCE, SD_STEPS, SD_STRENGTH,  # noqa: E402
                        STEPS, card_line, edit_pair, events_ms,
                        gaugan_edit_pair, gaugan_second_edit,
                        second_edit, timed_calls)

EDITS = ("a_first", "a_again", "b_first", "b_again")
PATHS = ("ddpm", "sd", "gaugan")
PEAK_LIMIT_MB = 10e9 / 2**20  # the decoder's sparse peak must stay under 10 GB


def edits(a, b):
    return dict(zip(EDITS, (a, a, b, b)))


def limit_inside(module):
    """Records ``torch.backends.cudnn.benchmark_limit`` as it is inside the
    module's forwards."""
    seen = []
    module.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.backends.cudnn.benchmark_limit))
    return seen


def ddpm():
    from sige_torch.models.ddpm import DDPMUNetConfig
    from sige_torch.runners import DiffusionRunConfig, DiffusionRunner

    cfg = DDPMUNetConfig()
    runner = DiffusionRunner(cfg, DiffusionRunConfig(
        sampler_type="ddim", eta=0.0, sample_steps=STEPS, noise_level=500),
        device="cuda", seed=0)
    seen = limit_inside(runner.module)
    R = cfg.resolution
    secs = timed_calls([(k, lambda e=e: runner.generate(*e, seed=0))
                        for k, e in edits(edit_pair(R), second_edit(R)).items()])
    return {"generate_s": secs, "limit_inside": sorted(set(seen))}


def sd():
    from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
    from sige_torch.runners import SDRunConfig, SDRunner

    runner = SDRunner(SDUNetConfig(), SDVAEConfig(resolution=512),
                      SDRunConfig(ddim_steps=SD_STEPS, strength=SD_STRENGTH,
                                  guidance_scale=SD_GUIDANCE),
                      seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    uc, c = (torch.randn(1, 77, 768, generator=gen, device="cuda")
             for _ in range(2))
    R = runner.vae_cfg.resolution
    pairs = {k: [2.0 * a - 1.0 for a in e]
             for k, e in edits(edit_pair(R), second_edit(R)).items()}
    out = {"sdedit_s": timed_calls(
        [(k, lambda e=e: runner.sdedit(*e, uc=uc, c=c, seed=0))
         for k, e in pairs.items()])}
    x0, x1 = (runner._image(a) for a in pairs["b_again"])
    z0, z1 = runner.encode(x0), runner.encode(x1, mode="sparse")
    for mode, fwd, z in (("full", runner.decoder.full, z0),
                         ("sparse", runner.decoder.sparse, z1)):
        arg = runner._pre_decode(z)
        fwd(arg)
        median, _ = events_ms(lambda: fwd(arg), 20)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd(arg)
        torch.cuda.synchronize()
        out[f"decoder_{mode}"] = {
            "ms": median, "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
    return out


def gaugan():
    from sige_torch.models.gaugan import SPADEGenConfig
    from sige_torch.runners import GauGANRunner

    cfg = SPADEGenConfig()
    runner = GauGANRunner(cfg, device="cuda", seed=0)
    a = [runner.preprocess_input(lab) for lab in gaugan_edit_pair(cfg)]
    b = [runner.preprocess_input(lab) for lab in gaugan_second_edit(cfg)]
    secs = timed_calls([(k, lambda e=e: runner.generate(*e))
                        for k, e in edits(a, b).items()])
    return {"generate_s": secs}


def one_process(limit, paths):
    from sige_torch.nn import engine
    from sige_torch.ops import flash

    if limit is not None:
        engine.BENCHMARK_LIMIT = limit
    flash.LIBRARY.load()  # the kernel build out of the first edit's time
    out = {"card": card_line(), "benchmark_limit": engine.BENCHMARK_LIMIT}
    for name in paths:
        out[name] = {"ddpm": ddpm, "sd": sd, "gaugan": gaugan}[name]()
        torch.cuda.empty_cache()
    return out


def new_edit_cost(times):
    """(second edit minus its repeat, first edit minus its repeat), s."""
    return (times["b_first"] - times["b_again"],
            times["a_first"] - times["a_again"])


def summarize(runs, limits):
    """Per limit: the new-edit and first-edit costs of every run per path,
    the decoder's forwards, whether every run passes the decoder's bounds;
    and the limit the rule picks (None when no limit passes)."""
    table = {}
    for limit in limits:
        mine = [r for r in runs if r["benchmark_limit"] == limit]
        row = {"runs": len(mine)}
        for name, key in (("ddpm", "generate_s"), ("sd", "sdedit_s"),
                          ("gaugan", "generate_s")):
            if mine and name in mine[0]:
                costs = [new_edit_cost(r[name][key]) for r in mine]
                row[name] = {"new_edit_s": [c[0] for c in costs],
                             "first_edit_s": [c[1] for c in costs]}
        if mine and "sd" in mine[0]:
            dec = [(r["sd"]["decoder_sparse"], r["sd"]["decoder_full"])
                   for r in mine]
            row["decoder_sparse_ms"] = [s["ms"] for s, _ in dec]
            row["decoder_full_ms"] = [f["ms"] for _, f in dec]
            row["decoder_sparse_peak_mb"] = [s["peak_mb"] for s, _ in dec]
            row["passes"] = all(s["ms"] < f["ms"]
                                and s["peak_mb"] < PEAK_LIMIT_MB
                                for s, f in dec)
            if "ddpm" in row:
                row["cost_s"] = [d + s for d, s in zip(
                    row["ddpm"]["new_edit_s"], row["sd"]["new_edit_s"])]
        table[limit] = row
    passing = [l for l in limits if table[l].get("passes") and
               table[l].get("cost_s")]
    if not passing:
        return table, None
    best = min(passing, key=lambda l: statistics.median(table[l]["cost_s"]))
    lo, hi = min(table[best]["cost_s"]), max(table[best]["cost_s"])
    near = [l for l in passing if min(table[l]["cost_s"]) <= hi
            and max(table[l]["cost_s"]) >= lo]
    return table, min(near)


def repeated(limits, repeat, paths, out_path):
    runs = []
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as out:
        for r in range(repeat):
            order = limits[r % len(limits):] + limits[:r % len(limits)]
            for limit in order:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--limit",
                     str(limit), "--paths", *paths],
                    capture_output=True, text=True, timeout=900)
                if proc.returncode != 0:
                    raise RuntimeError(f"limit {limit}, round {r}: exit "
                                       f"{proc.returncode}\n{proc.stderr}")
                run = json.loads(proc.stdout.strip().splitlines()[-1])
                run["round"] = r
                runs.append(run)
                out.write(json.dumps(run) + "\n")
                out.flush()
                print(f"round {r} limit {limit}: " + "; ".join(
                    f"{n} " + ", ".join(f"{k} {v:.3f}" for k, v in run[n][
                        "sdedit_s" if n == "sd" else "generate_s"].items())
                    for n in paths), flush=True)
    table, chosen = summarize(runs, limits)
    return {"card": runs[0]["card"], "repeat": repeat, "paths": list(paths),
            "by_limit": table, "chosen": chosen}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--limit", type=int, default=None,
                    help="the engine's cudnn benchmark_limit (default: "
                         "sige_torch.nn.engine.BENCHMARK_LIMIT)")
    ap.add_argument("--paths", nargs="*", default=list(PATHS),
                    choices=PATHS)
    ap.add_argument("--repeat", type=int, default=0,
                    help="runs per limit, one process each (0: one run of "
                         "--limit in this process)")
    ap.add_argument("--limits", type=int, nargs="*", default=[1, 2, 3, 10])
    ap.add_argument("--out", default="chiprun_out/retime_runs.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("retime_cost: no CUDA device", file=sys.stderr)
        return 1
    if args.repeat:
        print(json.dumps(repeated(args.limits, args.repeat, args.paths,
                                  args.out)))
    else:
        print(json.dumps(one_process(args.limit, args.paths)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
