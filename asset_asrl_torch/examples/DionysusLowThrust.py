"""Mass-optimal Earth->Dionysus low-thrust transfer in MEE with a CSI
thruster (reference `examples/DionysusLowThrust.py`; conditions and scaling
after Junkins & Taheri, JGCD 2019, doi:10.2514/1.G003686)."""

import numpy as np
import asset_asrl_torch as ast
from asset_asrl_torch.Astro.ThrusterModels import CSIThruster
from asset_asrl_torch.Astro.AstroModels import MEETwoBody_CSI
import asset_asrl_torch.Astro.Constants as c

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


def run(nsegs=96, print_level=1):
    Isp_dim = 3000         # s
    Tmag_dim = .32         # N
    tf_dim = 3534 * c.day  # s
    mass_dim = 4000        # kg

    thruster = CSIThruster(Tmag_dim, Isp_dim, mass_dim)
    ode = MEETwoBody_CSI(c.MuSun, c.AU, thruster)
    tf = tf_dim / ode.tstar

    X0 = np.array([0.99969, -0.00376, 0.01628, -7.702e-6, 6.188e-7, 14.161])
    XF = np.array([1.5536, 0.15303, -0.51994, 0.01618, 0.11814, 46.3302])

    Istate = np.zeros(11)
    Istate[0:6] = X0
    Istate[6] = 1
    Istate[9] = .5

    ts = np.linspace(0, tf, 500)
    TrajIG = []
    for t in ts:
        State = np.zeros(11)
        State[0:6] = X0 + (XF - X0) * t / tf
        State[6] = 1
        State[7] = t
        State[9] = .5
        TrajIG.append(State)

    phase = ode.phase("LGL5", TrajIG, nsegs)
    phase.setControlMode("BlockConstant")
    phase.addBoundaryValue("Front", range(0, 8), Istate[0:8])
    phase.addLUNormBound("Path", range(8, 11), .000001, 1, 1)
    phase.addBoundaryValue("Back", [7], [tf])
    phase.addBoundaryValue("Back", range(0, 6), XF[0:6])
    phase.addValueObjective("Back", 6, -1.0)

    phase.optimizer.set_OptLSMode("AUGLANG")
    phase.optimizer.set_MaxLSIters(2)
    phase.optimizer.set_MaxAccIters(200)
    phase.optimizer.set_BoundFraction(.997)
    phase.optimizer.set_PrintLevel(print_level)
    phase.optimizer.set_deltaH(1.0e-6)
    phase.optimizer.set_EContol(1.0e-9)
    flag = phase.optimize()

    ConvTraj = phase.returnTraj()
    FinalMass = ConvTraj[-1][6] * mass_dim
    print("Final Mass   :", FinalMass, " kg")
    print("Mass Expended:", mass_dim - FinalMass, " kg")
    return flag, FinalMass, ConvTraj


if __name__ == "__main__":
    flag, FinalMass, ConvTraj = run()
    # re-integration check with the solved control table
    ode = MEETwoBody_CSI(c.MuSun, c.AU,
                         CSIThruster(.32, 3000, 4000))
    # (re-integration of the block-constant control is demonstrated in the
    # reference; here we just report the converged mass)
    print("flag", flag)
