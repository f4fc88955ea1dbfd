"""CLI: ``python -m tod_tpu_torch.bench --config N`` or ``--all``, on the
card; one JSON line a config.  A config the port has not ported exits
naming its ``ROADMAP.md`` item; under ``--all`` it prints a line saying so
and the others run."""

from __future__ import annotations

import argparse
import json


def main(argv=None, device=None) -> int:
    """Run the configs on ``device`` (default the card; raises without one)."""
    from tod_tpu_torch.bench.configs import CONFIGS, UNPORTED, refusal, run_config
    from tod_tpu_torch.core.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--config", type=int, choices=sorted(CONFIGS))
    g.add_argument("--all", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    for n in sorted(CONFIGS) if args.all else [args.config]:
        if args.all and n in UNPORTED:
            print(json.dumps({"config": n, "unported": refusal(n)}), flush=True)
            continue
        print(json.dumps(run_config(n, device=dev)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
