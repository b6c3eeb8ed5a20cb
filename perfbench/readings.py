"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/readings.py --workload <cell> --seeds <first> <count>
                                  [--control <first> <count>]

For each seed, one call of the cell's fleet (its records from the cold start,
untimed) judged by the plain reference as a run judges it: the program's
readings, whose largest is a limit's lower reading.  For each control seed,
the control: the reference computed in bfloat16, the precision below the
float32 that the configuration states, put in the program's place on the
same chains and judged by the float32 reference: the upper reading.  Prints a
JSON line a reading.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.lib import manifest, program, verdict  # noqa: E402


def program_reading(torch, sv, S, mesh, config, traffic, seed, device):
    window = run.Window(float('inf'))
    window.open()
    t0 = time.perf_counter()
    fleet = program.fleet(sv, S, traffic, seed=run.call_seed(seed, 0),
                          steps=traffic['records_per_call'], progress=window.progress, mesh=mesh,
                          device=device)
    call_s = time.perf_counter() - t0
    kept = run.retain(fleet, 0, seed, traffic, window)
    del fleet
    t0 = time.perf_counter()
    columns, final = run.replay(config, traffic, kept, run_device(device),
                                torch.float32)
    parted, observed = verdict.partings(kept['columns'], columns, kept['final'], final)
    return {'seed': seed, 'kind': 'program', **verdict.shares(parted), 'parted': parted,
            'chain_records': observed, 'chains': kept['chains'], 'call_s': call_s,
            'reference_s': time.perf_counter() - t0}


def control_reading(torch, config, traffic, seed, device):
    chains = run.sample(seed, 0, traffic['chains'], traffic['check_chains'])
    kept = {'call': 0, 'seed': run.call_seed(seed, 0), 'chains': chains}
    t0 = time.perf_counter()
    low_columns, low_final = run.replay(config, traffic, kept, device, torch.bfloat16)
    columns, final = run.replay(config, traffic, kept, device, torch.float32)
    parted, observed = verdict.partings(low_columns, columns, low_final, final)
    return {'seed': seed, 'kind': 'control bfloat16', **verdict.shares(parted), 'parted': parted,
            'chain_records': observed, 'chains': chains, 'seconds': time.perf_counter() - t0}


def run_device(device):
    return 'cuda:0' if device == 'cuda' else device


def main(argv=None, device='cuda', overrides=None, out=sys.stdout):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs=2, default=(0, 0))
    ap.add_argument('--control', type=int, nargs=2, default=(0, 0))
    args = ap.parse_args(argv)
    entry, _, config, traffic = manifest.cell(args.workload)
    traffic = dict(traffic, **(overrides or {}))
    import torch
    if device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA card is available')
    readings = []
    if args.seeds[1]:
        sv = program.load(device)
        S = program.action(sv, config, traffic)
        mesh = program.mesh(sv, traffic, device, entry['chips'])
        for seed in range(args.seeds[0], args.seeds[0] + args.seeds[1]):
            readings.append(program_reading(torch, sv, S, mesh, config, traffic, seed, device))
            print(json.dumps(readings[-1]), file=out, flush=True)
    for seed in range(args.control[0], args.control[0] + args.control[1]):
        readings.append(control_reading(torch, config, traffic, seed, run_device(device)))
        print(json.dumps(readings[-1]), file=out, flush=True)
    return readings


if __name__ == '__main__':
    main()
