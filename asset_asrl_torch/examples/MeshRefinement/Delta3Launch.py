"""Delta III 4-phase launch with adaptive mesh on every phase (reference
`examples/MeshRefinement/Delta3Launch.py`): known final mass
7529.7499 kg."""

from ..Delta3Launch import build_ocp


def run(print_level=1):
    ocp = build_ocp(print_level=print_level)
    ocp.setAdaptiveMesh(True)
    ocp.setMeshTol(1e-6)
    flag = ocp.optimize()
    mf = ocp.Phases[-1].returnTraj()[-1][6]
    print(f"Delta3 adaptive: flag {flag} final mass {mf:.4f} kg "
          f"(known 7529.7499)")
    return flag, mf


if __name__ == "__main__":
    run()
