"""ad_probe_ms.solve: family AD with Hessians (`BlockKKT._eval_core`) at
the last solve's final iterate, ms (`PSIOPT.measure_stage_times`, a
probe after the window, not a span inside the loop)."""


def read(run):
    return 1e3 * run.probe["func_ad"] if run.probe else None
