"""What the entries share: the phase of the cell's configuration and the
base its traffic perturbs."""


def make_phase(ast, config, cfg):
    """(phase, base vector): the configuration's transcribed phase and its
    initial guess, the base the traffic perturbs."""
    phase = config.build(ast, cfg)
    phase.optimizer.set_PrintLevel(3)
    return phase, phase.makeSolverInput()
