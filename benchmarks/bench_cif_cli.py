"""Wall-clock CLI benchmark on CIF (historical entry point).

Superseded by :mod:`benchmarks.bench_cli_wall`, which generalizes the
same measurement to any geometry; this wrapper keeps the original
name/CLI working.

Usage: python benchmarks/bench_cif_cli.py [n_frames]
"""

import sys

if __name__ == "__main__":
    sys.argv = [sys.argv[0]] + (sys.argv[1:2] or ["200"]) + ["352", "288"]
    from bench_cli_wall import main

    main()
