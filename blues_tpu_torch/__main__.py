"""Command-line interface: ``python -m blues_tpu_torch <command>``.

The port's counterpart of ``python -m blues_tpu``:

    python -m blues_tpu_torch run config.yml [--iterations N] [--replicas R] [--device cuda|cpu]
    python -m blues_tpu_torch info system.prmtop
    python -m blues_tpu_torch bench

``run`` builds the simulation from a YAML (or JSON) config on the card
unless ``--device cpu`` is given, runs it with the config's reporters and
prints the acceptance ratio. ``bench`` prints the switching-step benchmark's
JSON line (``bench.py``); it needs the card.
"""

from __future__ import annotations

import argparse
import json


def cmd_run(args):
    from blues_tpu_torch.config import create_simulation

    sim, md_reps, ncmc_reps = create_simulation(args.config, n_replicas=args.replicas, device=args.device)
    n_iter = args.iterations if args.iterations else None
    try:
        ratio = sim.run(n_iter, reporters=md_reps + ncmc_reps)
    finally:
        for rep in md_reps + ncmc_reps:
            rep.close()
    print(f"Acceptance ratio: {ratio:.4f}")


def cmd_bench(args):
    from blues_tpu_torch import bench

    bench.main()


def cmd_info(args):
    from blues_tpu_torch.core.prmtop import load_prmtop

    system = load_prmtop(args.prmtop)
    print(
        json.dumps(
            {
                "n_atoms": system.n_atoms,
                "n_bonds": len(system.bonds),
                "n_angles": len(system.angles),
                "n_torsions": len(system.torsions),
                "n_constraints": len(system.constraints),
                "n_exclusions": int(system.nonbonded.exclusions.shape[0]),
                "n_exceptions": int(system.nonbonded.exceptions_idx.shape[0]),
                "total_charge": round(float(system.nonbonded.charge.sum()), 6),
                "residue_names": sorted(set(system.topology.residue_names)),
                "box_nm": None if system.box is None else [round(float(v), 4) for v in system.box.diagonal()],
            },
            indent=2,
        )
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="blues_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="run a YAML/JSON-configured simulation")
    pr.add_argument("config")
    pr.add_argument("--iterations", type=int, default=None)
    pr.add_argument("--replicas", type=int, default=1)
    pr.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    pr.set_defaults(fn=cmd_run)

    pi = sub.add_parser("info", help="inspect an Amber prmtop")
    pi.add_argument("prmtop")
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="the switching-step benchmark on the card (one JSON line)")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
