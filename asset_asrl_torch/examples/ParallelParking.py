"""Minimum-time parallel parking into a tight slot (reference
`examples/ParallelParking.py`; problem from Li/Wang/Chu IEEE 2016 case 7,
also ICLOCS ExampleParallelParking).  Slot geometry enters through a tanh
Heaviside approximation whose sharpness k is a LOCKED static parameter,
stiffened between solves with subVariable — no retranscription."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


def CornerLoc(theta, locx, locy):
    xl = vf.cos(theta) * locx - vf.sin(theta) * locy
    yl = vf.sin(theta) * locx + vf.cos(theta) * locy
    return xl, yl


def Heavyside(x, k=10):
    return (1 + vf.tanh(k * x)) / 2


def FslotF(x, k, SL, SW):
    return (-Heavyside(x, k) + Heavyside(x - SL, k)) * SW


def Area(A, B, C):
    x1, y1 = A
    x2, y2 = B
    x3, y3 = C
    return vf.abs(x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)) / 2.0


class CarODE(oc.ODEBase):

    def __init__(self, l_front, l_axes, l_rear, b_width):
        self.l_front = l_front
        self.l_axes = l_axes
        self.l_rear = l_rear
        self.b_width = b_width
        self.AreaRef = (l_axes + l_front + l_rear) * 2 * b_width
        self.Aloc = [l_front + l_axes, b_width]
        self.Bloc = [l_front + l_axes, -b_width]
        self.Cloc = [-l_rear, b_width]
        self.Dloc = [-l_rear, -b_width]
        self.Locs = [self.Aloc, self.Bloc, self.Cloc, self.Dloc]

        XtU = oc.ODEArguments(6, 2)
        x, y, v, a, theta, phi = XtU.XVec().tolist()
        u1, u2 = XtU.UVec().tolist()
        xdot = v * vf.cos(theta)
        ydot = v * vf.sin(theta)
        vdot = a
        adot = u1
        thetadot = v * vf.tan(phi) / self.l_axes
        phidot = u2
        super().__init__(
            vf.stack([xdot, ydot, vdot, adot, thetadot, phidot]), 6, 2)

    def SlotBounds(self, SL, SW, CL):
        """Car corners between far curb and slot profile (tanh Heaviside
        slot, sharpness k passed as static param)."""
        x, y, theta, k = Args(4).tolist()
        terms = []
        for locx, locy in self.Locs:
            xl, yl = CornerLoc(theta, locx, locy)
            X = x + xl
            Y = y + yl
            terms.append(Y - CL)
            terms.append(-Y + FslotF(X, k, SL, SW))
        return vf.stack(terms)

    def CornerCon(self, SL):
        """Triangle-area corner collision constraint: the four triangles
        from each car corner to a slot corner must cover at least the
        car's planform area."""
        x, y, theta = Args(3).tolist()
        O = [0, 0]
        E = [SL, 0]
        ABCD = []
        for locx, locy in self.Locs:
            xl, yl = CornerLoc(theta, locx, locy)
            ABCD.append([x + xl, y + yl])
        A, B, C, D = ABCD
        eq1 = self.AreaRef - vf.sum([Area(O, A, B), Area(O, C, B),
                                     Area(O, A, D), Area(O, D, C)])
        eq2 = self.AreaRef - vf.sum([Area(E, A, B), Area(E, C, B),
                                     Area(E, A, D), Area(E, D, C)])
        return vf.stack(eq1, eq2)

    def FinalYCon(self):
        y, theta = Args(2).tolist()
        terms = []
        for locx, locy in self.Locs:
            xl, yl = CornerLoc(theta, locx, locy)
            terms.append(y + yl)
        return vf.stack(terms)

    def CurvatureFunc(self):
        phi, u2 = Args(2).tolist()
        return u2 / (self.l_axes * vf.cos(phi) ** 2)


def MakeState(x, y, thetadeg, t):
    XtU = np.zeros(9)
    XtU[0] = x
    XtU[1] = y
    XtU[4] = np.deg2rad(thetadeg)
    XtU[6] = t
    return XtU


def Main(nsegs1=50, nsegs2=150, print_level=1):
    SL, SW, CL = 5.0, 2, 3.5
    l_front, l_axes, l_rear, b_width = 0.839, 2.588, 0.657, 1.771 / 2
    phi_max = np.deg2rad(33)
    v_max, a_max, u1_max = 2, 0.75, 0.5
    curvature_dot_max = 0.6
    xmin, xmax = -10, 7.5
    x0, y0, theta0deg = -5.14, 1.41, 13.18

    ode = CarODE(l_front, l_axes, l_rear, b_width)
    XtU0 = MakeState(x0, y0, theta0deg, 0)
    TrajIG = [XtU0,
              MakeState(-0.0, y0, 0, 5),
              MakeState(5.5, y0, 10, 10),
              MakeState(1, -0.5, 20, 15),
              MakeState(1, -1, 0, 25)]

    k1, k2 = 75, 150

    phase = ode.phase("LGL5", TrajIG, nsegs1)
    phase.setStaticParams([k1])
    phase.setControlMode("BlockConstant")
    phase.addBoundaryValue("First", range(0, 7), XtU0[0:7])
    phase.addInequalCon("Path", ode.SlotBounds(SL, SW, CL), [0, 1, 4],
                        [], [0])
    phase.addInequalCon("Last", ode.FinalYCon(), [1, 4])
    phase.addBoundaryValue("Last", [2, 3], [0, 0])
    phase.addLUVarBound("Path", 0, xmin, xmax)
    phase.addLUVarBound("Path", 2, -v_max, v_max)
    phase.addLUVarBound("Path", 3, -a_max, a_max)
    phase.addLUVarBound("Path", 5, -phi_max, phi_max)
    phase.addLUVarBound("Path", 7, -u1_max, u1_max)
    phase.addLUFuncBound("Path", ode.CurvatureFunc(), [5, 8],
                         -curvature_dot_max, curvature_dot_max)
    phase.addInequalCon("Path", ode.CornerCon(SL), [0, 1, 4])
    phase.addValueLock("StaticParams", [0])
    phase.addDeltaTimeObjective(1)
    phase.optimizer.set_BoundFraction(.995)
    phase.optimizer.set_MaxIters(2000)
    phase.optimizer.set_PrintLevel(print_level)

    phase.solve_optimize()
    phase.refineTrajManual(nsegs2)
    phase.subVariable("StaticParams", 0, k2)   # sharpen the slot model
    phase.optimizer.set_KKTtol(1.0e-8)
    phase.optimize()

    Traj = phase.returnTraj()
    FinalTime = Traj[-1][6]
    print("ASSET Maneuver Time: ", FinalTime, " s")
    print("PAPER Maneuver Time: ", 18.426, " s")
    return FinalTime, Traj


if __name__ == "__main__":
    Main()
