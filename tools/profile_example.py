"""Where one example's time goes on the port's CPU path: runs one entry
of `chip_smoke.EXAMPLES` (at its JAX test's call) under cProfile and
prints the functions with the most cumulative time, and the shares of
the integrator's step loop, the PSIOPT solves and `torch.atleast_1d`.

    python tools/profile_example.py LABEL [N]

cProfile adds a cost to every Python call, so the shares are indicative
only; device times come from the card (`chip_smoke.py --examples`)."""

import cProfile
import os
import pstats
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    torch.set_num_threads(2)
    import asset_asrl_torch as ast
    ast.config.use_device("cpu")
    from chip_smoke import EXAMPLES, PortExamples, run_example
    spec = EXAMPLES[sys.argv[1]]
    prof = cProfile.Profile()
    prof.enable()
    run_example(ast, PortExamples(), spec.test or spec.full)
    prof.disable()
    stats = pstats.Stats(prof)
    total = stats.total_tt
    cum = {f"{k[0]}:{k[2]}": v[3] for k, v in stats.stats.items()}

    def share(pattern):
        return max((t for k, t in cum.items() if k.endswith(pattern)),
                   default=0.0) / total
    print(f"total {total:.1f} s; integrator steps "
          f"{share('Integrators/rk.py:step'):.0%}, PSIOPT solves "
          f"{share('Solvers/psiopt.py:_run'):.0%}, torch.atleast_1d "
          f"{share('functional.py:atleast_1d'):.0%}")
    stats.sort_stats("cumulative").print_stats(
        int(sys.argv[2]) if len(sys.argv) > 2 else 25)


if __name__ == "__main__":
    main()
