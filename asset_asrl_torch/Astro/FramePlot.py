"""Frame plotting helpers (reference `asset_asrl/Astro/FramePlot.py`).

Same public surface — PlotBase (addTraj/addPoint/Plot2d/Plot3d), CRPlot
(CR3BP frame: primaries + Lagrange points pre-registered), TBPlot
(two-body frame) — implemented independently on plain matplotlib.
Everything is stored as tidy per-item dicts and rendered in one pass;
matplotlib is imported lazily so headless/solver-only environments never
pay for it.

Port of `asset_asrl_tpu/Astro/FramePlot.py`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PlotBase", "CRPlot", "TBPlot"]


def _plt():
    import matplotlib
    matplotlib.use(matplotlib.get_backend() or "Agg")
    import matplotlib.pyplot as plt
    return plt


class PlotBase:
    """Collect named trajectories/points, then render 2d or 3d."""

    def __init__(self):
        self.Trajs = {}
        self.Points = {}

    # ------------------------------------------------------------ builders
    def addTraj(self, traj, name, color=None, marker="", markersize=0,
                linestyle="-"):
        arr = np.asarray([np.asarray(r, float) for r in traj])
        self.Trajs[name] = dict(xyz=arr[:, :3].T, color=color or None,
                                marker=marker, ms=markersize,
                                ls=linestyle)

    addPropTraj = addTraj

    def addTrajSeq(self, trajs, header="", tags=None, colp="plasma"):
        tags = list(range(len(trajs))) if tags is None else tags
        cols = self._palette(colp, len(trajs))
        for tr, tag, col in zip(trajs, tags, cols):
            self.addTraj(tr, f"{header}{tag}", color=col)

    def addPoint(self, point, name, color=None, marker="*", markersize=60,
                 markeredgewidth=0.5, edgcolor="black"):
        self.Points[name] = dict(p=np.asarray(point, float)[:3],
                                 color=color or None, marker=marker,
                                 ms=markersize, mew=markeredgewidth,
                                 ec=edgcolor)

    def addPointSeq(self, pts, header="", tags=None, colp="plasma",
                    marker="*"):
        tags = list(range(len(pts))) if tags is None else tags
        cols = self._palette(colp, len(pts))
        for p, tag, col in zip(pts, tags, cols):
            self.addPoint(p, f"{header}{tag}", color=col, marker=marker)

    def AddCircle(self, name, p, r, color=None, marker="", markersize=0,
                  linestyle="--"):
        th = np.linspace(0, 2 * np.pi, 720)
        ring = np.stack([p[0] + r * np.cos(th), p[1] + r * np.sin(th),
                         np.zeros_like(th), np.zeros_like(th)], axis=1)
        self.addTraj(ring, name, color=color, marker=marker,
                     markersize=markersize, linestyle=linestyle)

    @staticmethod
    def _palette(name, n):
        import matplotlib
        try:
            cmap = matplotlib.colormaps[name]
        except (AttributeError, KeyError):     # matplotlib < 3.6
            import matplotlib.cm as cm
            cmap = cm.get_cmap(name)
        return [cmap(i / max(n - 1, 1)) for i in range(n)]

    # ------------------------------------------------------------ renderers
    def Plot2dAx(self, ax, view=(0, 1), legend=True):
        i, j = view
        for nm, tr in self.Trajs.items():
            ax.plot(tr["xyz"][i], tr["xyz"][j], tr["ls"],
                    color=tr["color"], marker=tr["marker"] or None,
                    label=nm)
        for nm, pt in self.Points.items():
            ax.scatter([pt["p"][i]], [pt["p"][j]], s=pt["ms"],
                       c=[pt["color"]] if pt["color"] else None,
                       marker=pt["marker"], edgecolors=pt["ec"],
                       linewidths=pt["mew"], label=nm, zorder=5)
        ax.set_aspect("equal", adjustable="datalim")
        if legend:
            ax.legend(loc="best", fontsize=8)
        return ax

    def Plot2d(self, show=True, view=(0, 1), save=None):
        plt = _plt()
        fig, ax = plt.subplots()
        self.Plot2dAx(ax, view=view)
        if save:
            fig.savefig(save, dpi=150, bbox_inches="tight")
        if show:
            plt.show()
        return fig, ax

    def Plot3dAx(self, ax, legend=True):
        for nm, tr in self.Trajs.items():
            ax.plot(tr["xyz"][0], tr["xyz"][1], tr["xyz"][2], tr["ls"],
                    color=tr["color"], label=nm)
        for nm, pt in self.Points.items():
            ax.scatter([pt["p"][0]], [pt["p"][1]], [pt["p"][2]],
                       s=pt["ms"], marker=pt["marker"],
                       c=[pt["color"]] if pt["color"] else None,
                       edgecolors=pt["ec"], label=nm)
        if legend:
            ax.legend(loc="best", fontsize=8)
        return ax

    def Plot3d(self, show=True, save=None):
        plt = _plt()
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        self.Plot3dAx(ax)
        if save:
            fig.savefig(save, dpi=150, bbox_inches="tight")
        if show:
            plt.show()
        return fig, ax


class CRPlot(PlotBase):
    """CR3BP frame plot: primaries and Lagrange points pre-registered
    from the frame/ode object (reference CRPlot)."""

    def __init__(self, ode, p1name="P1", p2name="P2", p1col="gold",
                 p2col="teal"):
        super().__init__()
        mu = getattr(ode, "mu", None)
        src = ode if mu is not None else getattr(ode, "frame", ode)
        mu = getattr(src, "mu", 0.01)
        self.mu = float(mu)
        self.addPoint([-self.mu, 0, 0], p1name, color=p1col, marker="o",
                      markersize=90)
        self.addPoint([1 - self.mu, 0, 0], p2name, color=p2col,
                      marker="o", markersize=50)
        for nm in ("L1", "L2", "L3", "L4", "L5"):
            pt = getattr(src, nm, None)
            if pt is not None:
                self.addPoint(np.asarray(pt, float)[:3], nm,
                              color="gray", marker="+", markersize=40)


class TBPlot(PlotBase):
    """Two-body frame plot: central body at the origin."""

    def __init__(self, ode, p1name="P1", p1col="gold"):
        super().__init__()
        self.addPoint([0, 0, 0], p1name, color=p1col, marker="o",
                      markersize=90)
