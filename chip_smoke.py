#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`asset_asrl_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. device: a CUDA card must be visible; prints its name, power limit and
   the torch / CUDA versions;
2. build: compiles kernel K1 (`asset_asrl_torch/csrc/gj_inverse.cu`,
   `gj_inverse_wide.cu`) and prints what `ptxas -v` reported;
3. K1 against its plain PyTorch versions on seeded symmetric
   quasi-definite blocks, f64 and f32: the narrow kernels at the
   block-cyclic-reduction shapes of the 10^4-node problems, the wide
   (blocked) kernel at border widths 65 to 1029 against both the
   unblocked and the blocked plain version; the fused bad-pivot count
   against the plain count, also on blocks with a zero and a NaN pivot;
   a second run bitwise equal to the first; each kernel timed at several
   shapes beside its bound, its plain version and `torch.linalg.inv_ex`;
4. BCR factor/solve on the card against a dense solve and eigvalsh
   inertia;
5. the CartPole swing-up (LGL5, 40 segments) through `phase.optimize()`
   against its known flag / iterations / objective, and a bitwise
   repeatability check of one factorization;
6. the same problem at 5000 segments (10,001 collocation nodes), with
   time-to-solution, iterations/s and peak device memory;
7. single-phase breadth: the Brachistochrone under all five
   transcriptions and the CartPole in the BlockConstant and
   HighestOrderSpline control modes, against the JAX package's flags,
   iterations and objectives;
8. formation flying (two phases, PathToPath link) at 80, 256 and 512
   segments per phase: the border (segments + 5 wide) goes through the
   wide K1 kernel;
9. the 4-phase Delta III launch at 40 segments per phase through
   `ocp.solve_optimize()`, and a bitwise repeatability check of one
   factorization;
10. Delta III at 2500 segments per phase (10,004 nodes), with
   time-to-solution, iterations/s and peak device memory;
11. the integrator: 4096 seeded two-body rows over one period each with
   DOPRI87 in one batched call (against the port's own CPU run of 16 of
   them, the JAX package's numbers for 4 of them, and the closed orbit),
   the state-transition matrices of 256 of them, and a batch of
   periapsis-crossing stop events;
12. the hypersensitive problem (LGL7, tf = 10000, MeshTol 1e-6) through
   `phase.solve_optimize()` with the adaptive mesh on: every re-solve
   factors another K;
13. the adaptive-mesh Delta III (40 segments a phase to start, "deboor",
   MeshTol 1e-7) through `ocp.solve_optimize()`, against the JAX package
   and the published optimum;
14. the three mesh-error estimators on the solved Delta III of phase 10
   (10,004 nodes; "integrator" is one batched propagation of 2500
   segments a phase), and an auto-scaled CartPole at 10,001 nodes with
   unit 1 on every variable against the unscaled solve of phase 6;
15. the default solve (the fused PSIOPT loop with the least-squares
   multiplier start) on the Brachistochrone, the CartPole at 40 and 5000
   segments and formation flying at 256 segments a phase (two linked
   phases, the wide K1 kernel under the fused loop), against the JAX
   package's default solve; `PSIOPT.init`
   and ReturnBest against the JAX package; time-to-solution, host reads
   and factorizations per iteration, peak memory and the stage times;
16. scenario ensembles through `parallel.solve_ensemble`: the
   MultiSpacecraft rendezvous leg of `examples/MultiSpacecraftOptimization.py`
   at 512 scenarios and the CartPole at 10,001 nodes at 16 scenarios,
   each K1 launch covering every lane of a reduction level; lane 0 and the
   lane with the most iterations solved alone must equal their lanes;
17. the VectorFunctions tail: the table-driven minimum time to climb
   (`examples/MinimumTimeToClimb.py`: cubic 1-D and 2-D interpolation
   tables in the dynamics, 50 segments) against the JAX package's default
   solve; the Kepler-equation root-finder node in a family of 65,536 rows
   (values, Jacobians, adjoint Hessians) against the port's CPU run and
   the JAX package; a Python callback (`PyVectorFunction`) inside an
   expression;
18. Astro: an Earth to Mars porkchop grid of 262,144 Lambert solves in
   one batched call (against JAX, the CPU, Kepler's equation and the
   propagated arrival states), the Dionysus low-thrust transfer (MEE,
   constant specific impulse) at 150 segments against the JAX package's
   default solve and at 1000 segments, the EPPR and NBody frames'
   equations of motion over 4096 rows against the CPU;
19. the Solvers tail against its CPU results: Rosenbrock through
   `OptimizationProblem` under three line-search modes, a phase on the
   dense KKT backend, and `Jet.map` over three phases;
20. distribution on a one-rank NCCL process group: the 10,001-node
   CartPole's default solve on the block backend and sharded (flat over 8
   shards, hierarchical over a (2, 4) mesh), the neigs and residuals of
   one factor + solve of each at the converged blocks, formation flying
   at 256 segments a phase sharded (the wide reduced border), a 16-lane
   ensemble over a scenario mesh against no mesh, `Utils.Profiler`
   around one sharded factor, and K1 timed at the sharded launch shapes.

Phases 5 to 14 hold the port to the JAX package's host loop, so their
problems run the port's host loop too (`UseFused = False`); phases 15 and
16 run the default, fused, loop.  Every phase resets the K1 launch counts
just before it drives its problem and reads them just after.  The line
before the last two is a JSON object describing every kernel of the main
path (narrow K1 launches from phase 10, wide K1 launches from the
256-segment run of phase 8, and under `launches_elsewhere` those of the
solves of phases 12 to 20); phases 17 to 20 print each run's time, peak
device memory and K1 launches; then the card's name and power limit; the
last line is the JSON device record.
"""

import contextlib
import gc
import json
import re
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

OBJ_40 = 58.81031764081469       # JAX package, CPU host loop, 40 segments
OBJ_5000 = 58.80766768910606     # JAX package, CPU host loop, 5000 segments

# The JAX package's CPU host loop (x64, UseFused=False) on the single-phase
# breadth problems: (flag, iterations, objective)
BRACH_24 = {"LGL3": (0, 12, 1.8012955176398973),
            "LGL5": (0, 11, 1.8012954691248915),
            "LGL7": (0, 11, 1.8012954818675209),
            "Trapezoidal": (0, 12, 1.801672045694481),
            "CentralShooting": (0, 12, 1.8012954817635052)}
CARTPOLE_128 = {"BlockConstant": (0, 11, 58.85687489351558),
                "HighestOrderSpline": (0, 12, 58.807699727465184)}
# formation flying (PathToPath link), per-phase segments ->
# (flag, iterations, objective, border width b)
FORMATION = {8: (0, 3, 3.08847184948195, 13),
             80: (0, 3, 3.0009299750648717, 85),
             256: (0, 3, 3.000091316839824, 261),
             512: (0, 3, 3.000022859525826, 517)}
# Delta III, LGL3 segments per phase -> (flag, iterations of
# solve_optimize, final mass in kg)
DELTA3 = {40: (0, 40, 7529.748664196064),
          2500: (0, 53, 7528.398909956162)}
# the adaptive-mesh Delta III of `tests/test_delta3.py` (40 segments a
# phase to start, "deboor", MeshTol 1e-7): (flag, final segments per
# phase, final mass in kg).  The first estimate is already under the
# tolerance in every phase, so no phase is refined.
DELTA3_ADAPTIVE = (0, [40, 40, 40, 40], 7529.748664196064)
DELTA3_PUBLISHED = 7529.749892668763
# the hypersensitive problem of `tests/test_adaptivemesh.py`: (flag,
# segments at each mesh estimate, objective)
HYPERSENS = (0, [10, 59, 380, 1414], 1.6732960912289117)

# The JAX package's numbers below come from `tools/port_references.py`
# (`--all` for the 5000-segment CartPole and the 512 scenarios).
# The JAX package's default solve (the fused loop with the least-squares
# multiplier start; x64, CPU): (flag, iterations, objective)
FUSED = {"Brachistochrone LGL3 24": (0, 8, 1.8012955182586587),
         "CartPole LGL5 40": (0, 10, 58.810317640814674),
         "CartPole LGL5 5000": (0, 14, 58.80766768903671),
         "formation 256": (0, 3, 3.000091316839824)}
# The JAX package's PSIOPT.init on the 40-segment CartPole with a control
# guess of 1 (with the benchmark's guess of 0 the objective gradient, and
# with it every least-squares multiplier, is 0): (|lamE|, lamE[:4], the
# index of the largest |lamE|)
INIT_40 = (25.02271521012259, [0.8609886057067565, -3.231524962787345,
                               -1.3036428454937703, 0.09358654298006391], 361)
# ReturnBest on the 24-segment LGL3 Brachistochrone capped at 4
# iterations: (flag, iterations, objective of the best iterate)
RETURN_BEST = (2, 4, 1.7648249876336402)
# The MultiSpacecraft leg: the baseline default solve (flag, iterations,
# objective), and the JAX package's solve_ensemble of 512 scenarios about
# it (every lane: flag 0 in 3 iterations; the objectives of lanes 0-3)
MSC_BASE = (0, 5, 0.5942206860287187)
MSC_512 = (0, 3, [0.594220686011265, 0.5942206860088641,
                  0.5942206860060142, 0.5942206860108289])
# the Dionysus transfer's start mass, kg
DIONYSUS_MASS = 4000.0
# the JAX package's default solve of the table-driven climb at 50 segments:
# (flag, iterations, objective)
CLIMB_50 = (0, 16, 1.2868527875593079)
# the JAX package's Kepler root-finder family (`kepler_family`) on the first
# 4 rows of `kepler_rows`: values, Jacobians, adjoint Hessians, flattened
KEPLER_FAMILY_4 = (
    [1.3300076706179056, 2.2961415866512938, 10.028060509832011,
     10.37200210481439, 3.122547271028688, 4.3877251577635805,
     2.838177272405056, 4.694014264528828],
    [0.0, 2.817149857116009, 2.5649248713794215, 0.0, 4.374371344560321,
     3.6605279187586537, 0.0, 3.2639468847917734, 5.240883705313322, 0.0,
     0.4067867480830542, 4.082646060171713, 0.0, 4.178384744118625,
     3.247171463168261, 0.0, 3.3271218420611084, 3.1553785235595493, 0.0,
     -3.2471620987526664, -3.135508691324047, 0.0, 2.9416158863757706,
     -3.1787067634756565],
    [0.0, 0.0, 0.0, 0.0, 1.2250796253539065, 0.13122560765682184, 0.0,
     0.1312256076568219, 1.1104586663055764, 0.0, 0.0, 0.0, 0.0,
     6.802074853080493, 2.9494494330588585, 0.0, 2.949449433058858,
     -0.7402853677786007, 0.0, 0.0, 0.0, 0.0, -5.453048596221889,
     -1.4510836293249934, 0.0, -1.4510836293249934, -0.7878760781542926,
     0.0, 0.0, 0.0, 0.0, -2.618597783955013, 0.6849404879247415, 0.0,
     0.6849404879247414, 0.91715380901918])
# the JAX package's Lambert solutions (v1, v2 flattened) on the 64 seeded
# lanes of the porkchop grid (`porkchop_lanes`)
PORKCHOP_64 = (
    [-0.7155731903885074, 0.7794744952207854, 0.02192824158291192,
     -1.1255698518688502, 0.13782309702810447, 0.0034342390221335133,
     0.5955389231717341, -0.751995326337845, -0.029684806528014116,
     0.6314954145745333, -0.703654306370224, -0.03570890318488135,
     0.7966207393685412, -0.6086205595584584, -0.025736556448851953,
     0.9243894335835473, -0.3568690954692835, -0.02790795096894356,
     -0.9098641841639569, -0.5296151178861125, 0.005224649762388366,
     0.9978047653586052, -0.07881444867568808, -0.02546936765944851,
     0.9330987619353295, 0.8531069121663312, -0.027437530437973125,
     0.5994113915865678, 0.8024095722672809, 0.025271283489616048,
     0.25948003313467854, 0.9829705129600567, 0.03075677354259261,
     -0.5376584022355851, 0.9299089005340084, 0.01225585448957539,
     -0.6452855219534271, 0.8316552366856742, 0.029585545908421065,
     -0.9721871676500156, 0.47522644338421616, 0.034798799892259376,
     -1.0272677615171633, 0.30203996424738044, 0.0360156477041897,
     -0.4131326410059451, -1.013656755872283, -0.07094966405477357,
     0.24854988355844063, -1.0834561660871618, -0.02248217951778182,
     0.5834990707689001, -0.9345631732953358, -0.02066796883161779,
     0.6081833995933753, -0.9228743932636634, -0.024012793325660416,
     0.6361050610037078, -0.9082536456711703, -0.026822500965926206,
     0.7206641233962878, -0.8357799049469548, -0.027391078779238527,
     1.04564525569263, 0.031652025434623775, -0.00440592661064642,
     0.4190419047466124, 0.33805221475563557, -0.9846557195162742,
     0.19455388622209885, 0.9776418825373493, 0.017808210741163344,
     -1.1135911634392044, 0.25464629221761564, -0.0036224098947041585,
     0.29951202420453416, -1.0324251361338375, -0.014217160049016596,
     -1.033501784163773, 0.19745461555014335, 0.015448352199686361,
     -0.709646589136213, -0.8850696559957772, -0.02812043448284261,
     1.0396744104828883, 0.21860356090343808, -0.021006227576947836,
     -0.3916285919116768, -0.9876151787873292, -0.011028759839637454,
     0.7467532294171504, 1.143182696875753, -0.021487053477965083,
     0.45468692019566537, -0.9804234465593686, -0.01858449509805461,
     0.33221872598777746, -1.0072935262008158, -0.017126880733946036,
     0.5357649069327339, 0.8110502377604779, 0.015344626139296299,
     0.41403091129784964, 1.0511574145744147, -0.015191000309643602,
     0.7179989723617525, -0.7852916944330449, -0.01755285810003515,
     -0.12636663270987064, 1.2655383749521114, -0.018782233198160067,
     -0.22765265255854278, 1.0955223834658383, -0.00507303440484169,
     -0.501078210256133, 0.9310941787644587, 0.01349287942143119,
     -0.795112361346232, 0.6801666296353353, 0.027128728589976843,
     -0.8942957709129994, 0.5235103568528274, 0.032665423305419654,
     -0.9945099104384942, 0.3110183194712731, 0.031324063660975635,
     -1.037350408804175, 0.23206721338885034, 0.035882051624904036,
     -1.0150677841660336, -0.3137993805166033, 0.009316963877475761,
     -1.147733268809926, -0.3310825000220386, -0.48329651891934383,
     -1.033613802122692, -0.23503749910835436, 0.026472734115799843,
     -0.9537346241988691, -0.4858062716159157, 0.0046900925434035096,
     -0.16128329173520595, -1.0847857584437377, -0.04768286265229592,
     -0.059082874959843205, -1.0992976258581213, -0.05204065451852169,
     -0.739963171076459, -0.7826048553992474, 0.003517316930860841,
     0.720953645979193, -0.8396901339512091, -0.034028440541797204,
     1.0085387601921658, -0.4005813932935672, -0.010018336367857697,
     0.9157647087169024, 0.2721442759953191, 0.540771634199707,
     0.7933189869849384, 0.7314986888730834, 0.023603552176657026,
     0.7330765776692713, 0.7196402381821514, -0.007156482323040464,
     0.5841893012754245, 0.9098469347294945, 0.030320231478951024,
     -0.1693730816845359, 1.0659727425822667, 0.03138472733569251,
     -0.11251917506803442, 0.9921905702085344, 0.02364078297710442,
     -0.3626817854390953, 0.9830193613433434, 0.02765946637162555,
     -0.13343811493044536, 0.8929737272877712, 0.02427128715184447,
     -1.0803405587757797, -0.3808317822837039, -0.060566108903896125,
     -0.6414598931956583, -0.9410347285808505, -0.053462967765376776,
     -0.832403663547186, -0.6711052219724746, -0.0066852107469986075,
     1.0594296636681761, -0.016837853694674075, -0.019577298546399582],
    [0.2536267594061198, -0.47252889085458144, -0.00510684196224354,
     0.7268871022393143, -0.017600326690613486, -0.0024100279902060976,
     -0.3273774684164342, -0.10850417939541328, -0.011053565156628037,
     -0.17532715502454968, -0.2324578575233224, -0.02025250334432467,
     -0.4569242840385629, -0.04485475552922898, -0.0015083944443502941,
     -0.3182145752000738, -0.2948989187521164, -0.0062493775796803085,
     0.5365971675183933, 0.2921883435071154, -0.002029259639593508,
     -0.2439618662191868, -0.40191568768235064, -0.004325219086062113,
     -0.9106739428315493, -0.02865259665939429, 0.03080300196362077,
     0.556302076323487, 0.262700771048424, 0.021505562690370322,
     0.6090103616257638, 0.272592003246361, 0.0209838951883485,
     0.5616238994574534, -0.4085685551850968, -0.006134944287831094,
     0.6436521320590354, 0.32192229691986596, 0.0012457702409007366,
     0.7262855757572227, -0.06869691024422336, -0.020017881978859654,
     0.535071805975858, 0.5224669715742953, -0.008268780589597463,
     0.6794737586088019, 0.39041651137905037, 0.04064481192182562,
     -0.6938940844389064, -0.15071229301681643, -0.002785510218729889,
     -0.7195402700616071, 0.1080728435719717, 0.008242636414445666,
     -0.7202646274375282, -0.01570544706296373, 0.007199717657811156,
     -0.6982389638996597, -0.14571580854253344, 0.005001705473599209,
     -0.7216239131051764, -0.005238731881094244, 0.010820420329977674,
     -0.5473729247729243, 0.4485778955201026, 0.001666965349255727,
     -0.008880710600627485, -0.36509253219141613, 0.5929845755088815,
     -0.42132947672520027, -0.27072435314495913, 0.000667135064685947,
     0.7560465716476219, 0.01492612610373726, 0.0027062238140953183,
     -0.21300039171140606, 0.5841004621562288, 0.005901127999242507,
     0.4980825811503348, -0.22215938161295765, -0.003788031008712585,
     0.30100790774875325, 0.7798042785413706, 0.02506269438984802,
     -0.5311519448702925, -0.26104067041458645, 0.007613236467832493,
     0.2894734536934078, 0.655275760636163, 0.0065860767408984534,
     -1.037482376970159, -0.14456652606147316, 0.03140038313518382,
     -0.36340449894770943, 0.7151985471063886, 0.014899581569376054,
     -0.23238784368254725, 0.7283260570102196, 0.011877170271096353,
     0.5600304287962413, -0.025013873036219568, 0.009888204006233992,
     -0.3843675572111379, -0.6232187310456048, 0.01137831169905901,
     -0.5257906435042554, 0.5767185613225848, 0.012789336725653832,
     -0.6078083921393638, -0.708868743858199, 0.02054660984187357,
     0.030924975116513383, -0.735901147506565, 0.0036910165711130562,
     0.5520595954391267, -0.40072091846574937, -0.00601243015886608,
     0.6953789859896254, 0.062199208515971015, -0.008022312457719848,
     0.3578135894859125, 0.6131423114253816, 0.007132144539891485,
     -0.24289800439302558, 0.6652822034840093, 0.020615155490315513,
     0.6837563986403145, 0.2511738010035021, -0.01665550175919848,
     -0.6764356584943657, 0.14605632742605956, 0.007818288117555345,
     0.4170170815017754, -0.8348617295517069, 0.3100854394008644,
     0.011352668994344875, 0.7287645942822096, 0.00014829327781281634,
     -0.6215778360143872, 0.3135658963671047, 0.002961709079950849,
     -0.1933793689069909, -0.6368395051901169, -0.04295391407402837,
     -0.17979971442310577, -0.635652972262894, -0.046166037168169805,
     -0.5666834752859057, 0.4214445492526816, 0.0009565547257627677,
     -0.41143236609652784, -0.5280370176870263, -0.010486821149722964,
     -0.4478131686429552, 0.6142073961872098, 0.005979480983339853,
     -0.5763399970969579, -0.18216754349101516, -0.34231819121804336,
     -0.6855488562449372, 0.04873887382765147, -0.008112017089991486,
     -0.3245289898065135, 0.5936309393679113, -0.0030570167743446263,
     -0.6410870062265468, -0.16995507665664242, -0.010482989136524913,
     -0.2829970242335674, -0.5293889721581105, -0.00850882335266228,
     -0.4163065169051702, -0.23034484069200803, 0.005064745190782849,
     -0.24065405955276217, -0.4774609632016976, -0.0017032140621485105,
     -0.20434700259491573, -0.08451599786884235, 0.012788152335864255,
     0.5438330379886679, 0.6292026842191069, 0.04900749139804271,
     0.09302777102361029, 0.8493714748402831, 0.046398630077428143,
     0.5764484165116467, 0.36507576979689044, 0.003512574751661263,
     -0.5672181412156768, -0.08829609959485331, 0.006450736998698415])
# the JAX package's default solve of the Dionysus transfer at 150 segments:
# (flag, iterations, final mass in kg)
DIONYSUS_150 = (0, 52, 2715.9311712080384)


def cartpole_ode(ast):
    """The CartPole ODE of the repository's benchmark, built with either
    package's namespace (`asset_asrl_torch` or `asset_asrl_tpu`)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class CartPole(oc.ODEBase):
        def __init__(self, l, m1, m2, g):
            XtU = oc.ODEArguments(4, 1)
            x, th, xd, thd = XtU.XVec().tolist()
            F = XtU.UVar(0)
            Q = vf.stack([-g * vf.sin(th),
                          F + m2 * l * vf.sin(th) * thd ** 2])
            M = vf.RowMatrix(vf.stack(vf.cos(th), l, m1 + m2,
                                      m2 * l * vf.cos(th)), 2, 2)
            super().__init__(vf.stack([xd, thd, M.inverse() * Q]), 4, 1)

    m1, m2, l, g = 1, .3, .5, 9.81
    return CartPole(l, m1, m2, g)


def build_cartpole(ast, nsegs, tmode="LGL5", cmode=None, u0=.0):
    """The CartPole swing-up phase of the repository's benchmark (LGL5,
    default control mode unless `cmode` is given; `u0` is the control of
    the initial guess), built with either package's namespace."""
    vf = ast.VectorFunctions
    tf, xf = 2.0, 1.0
    ts = np.linspace(0, tf, 100)
    IG = [[xf * t / tf, np.pi * t / tf, 0, 0, t, u0] for t in ts]
    phase = cartpole_ode(ast).phase(tmode, IG, nsegs)
    if cmode is not None:
        phase.setControlMode(cmode)
    phase.addBoundaryValue("First", range(0, 5), [0, 0, 0, 0, 0])
    phase.addBoundaryValue("Last", range(0, 5), [xf, np.pi, 0, 0, tf])
    phase.addLUVarBound("Path", 5, -20.0, 20.0)
    phase.addLUVarBound("Path", 0, -2.0, 2.0)
    phase.addIntegralObjective(vf.Arguments(1)[0] ** 2, [5])
    return phase


def build_brachistochrone(ast, tmode, nsegs=24):
    """The Brachistochrone of `tests/test_fullproblems.py`, built with
    either package's namespace."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    g = 9.81

    class Brachistochrone(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(3, 1)
            x, y, v = XtU.XVec().tolist()
            theta = XtU.UVar(0)
            super().__init__(vf.stack([vf.sin(theta) * v,
                                       -1.0 * vf.cos(theta) * v,
                                       g * vf.cos(theta)]), 3, 1)

    x0, y0, v0, theta0, xf, yf, tf = 0, 10, 0, 1.0, 10, 5, 1
    ts = np.linspace(0, tf, 100)
    IG = [[x0 + (xf - x0) * t / tf, y0 + (yf - y0) * t / tf,
           g * t * np.cos(theta0), t, theta0] for t in ts]
    phase = Brachistochrone().phase(tmode, IG, nsegs)
    phase.addBoundaryValue("Front", range(0, 4), [x0, y0, v0, 0])
    phase.addLUVarBound("Path", 4, -0.1, 2.00)
    phase.addBoundaryValue("Back", [0, 1], [xf, yf])
    phase.addDeltaTimeObjective(1.0)
    return phase


def build_formation(ast, nsegs):
    """Formation flying of `tests/test_pathtopath.py`: two double
    integrators, phase B held at a fixed offset from phase A at every
    node by a PathToPath link.  Returns (ocp, phase A, phase B)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments

    class DoubleIntegrator(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    def phase(x0, xf):
        ts = np.linspace(0, 2, 20)
        IG = [[x0 + (xf - x0) * t / 2, (xf - x0) / 2, t, 0.0] for t in ts]
        ph = DoubleIntegrator().phase("LGL3", IG, nsegs)
        ph.addBoundaryValue("Front", [0, 1, 2], [x0, 0, 0])
        ph.addBoundaryValue("Back", [0, 1, 2], [xf, 0, 2])
        ph.addIntegralObjective(Args(1)[0] ** 2, [3])
        return ph

    pa, pb = phase(0.0, 1.0), phase(0.2, 1.2)
    ocp = oc.OptimalControlProblem()
    ocp.addPhase(pa)
    ocp.addPhase(pb)
    A = Args(2)
    ocp.addDirectLinkEqualCon(A[0] - A[1] + 0.2, pa, "Path", [0],
                              pb, "Path", [0])
    return ocp, pa, pb


# Delta III launch (`tests/test_delta3.py`), canonical units
D3 = dict(Lstar=6378145, Tstar=961.0, Mstar=301454.0)


def build_delta3(ast, nsegs, adaptive=False):
    """The 4-phase Delta III launch of `tests/test_delta3.py` on a mesh of
    `nsegs` LGL3 segments per phase, with the test's L1 line searches and
    MaxLSIters 2, built with either package's namespace.  The mesh is
    fixed, or with `adaptive` refined as in that test ("deboor" estimator,
    MeshTol 1e-7, at most 4 mesh iterations).  Returns (ocp, phases)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments
    Lstar, Tstar, Mstar = D3["Lstar"], D3["Tstar"], D3["Mstar"]
    g0 = 9.80665
    Astar = Lstar / Tstar ** 2
    Vstar = Lstar / Tstar
    Rhostar = Mstar / Lstar ** 3
    Mustar = Lstar ** 3 / Tstar ** 2
    Fstar = Astar * Mstar
    mu = 3.986012e14 / Mustar
    Re = 6378145 / Lstar
    We = 7.29211585e-5 * Tstar
    RhoAir = 1.225 / Rhostar
    h_scale = 7200 / Lstar
    g = g0 / Astar
    CD, S = .5, 4 * np.pi / Lstar ** 2
    TS, T1, T2 = 628500 / Fstar, 1083100 / Fstar, 110094 / Fstar
    IS, I1, I2 = 283.33364 / Tstar, 301.68 / Tstar, 467.21 / Tstar
    tS, t1, t2 = 75.2 / Tstar, 261 / Tstar, 700 / Tstar
    TMS, TM1, TM2, TMPay = (19290 / Mstar, 104380 / Mstar, 19300 / Mstar,
                            4164 / Mstar)
    PMS, PM1, PM2 = 17010 / Mstar, 95550 / Mstar, 16820 / Mstar
    SMS, SM1 = TMS - PMS, TM1 - PM1
    T_phase = [6 * TS + T1, 3 * TS + T1, T1, T2]
    mdot_phase = [(6 * TS / IS + T1 / I1) / g, (3 * TS / IS + T1 / I1) / g,
                  T1 / (g * I1), T2 / (g * I2)]
    tf_phase = [tS, 2 * tS, t1, t1 + t2]
    m0_1 = 9 * TMS + TM1 + TM2 + TMPay
    mf_1 = m0_1 - 6 * PMS - (tS / t1) * PM1
    m0_2 = mf_1 - 6 * SMS
    mf_2 = m0_2 - 3 * PMS - (tS / t1) * PM1
    m0_3 = mf_2 - 3 * SMS
    mf_3 = m0_3 - (1 - 2 * tS / t1) * PM1
    m0_4 = mf_3 - SM1
    mf_4 = m0_4 - PM2
    m0_phase = [m0_1, m0_2, m0_3, m0_4]
    mf_phase = [mf_1, mf_2, mf_3, mf_4]

    class RocketODE(oc.ODEBase):
        def __init__(self, T, mdot):
            XtU = oc.ODEArguments(7, 3)
            R = XtU.XVec().head3()
            V = XtU.XVec().segment3(3)
            m = XtU.XVar(6)
            u = XtU.UVec().normalized()
            h = R.norm() - Re
            rho = RhoAir * vf.exp(-h / h_scale)
            Vr = V + R.cross(np.array([0, 0, We]))
            D = (-0.5 * CD * S) * rho * (Vr * Vr.norm())
            Vdot = (-mu) * R.normalized_power3() + (T * u + D) / m
            super().__init__(vf.stack(V, Vdot, -mdot), 7, 3)

    def target_orbit(at, et, it, Ot, Wt):
        R, V = Args(6).tolist([(0, 3), (3, 3)])
        r, v = R.norm(), V.norm()
        hvec = R.cross(V)
        nvec = vf.cross([0, 0, 1], hvec)
        eps = 0.5 * (v ** 2) - mu / r
        a = -0.5 * mu / eps
        evec = V.cross(hvec) / mu - R.normalized()
        e = evec.norm()
        i = vf.arccos(hvec.normalized()[2])
        O = vf.arccos(nvec.normalized()[0])
        O = vf.ifelse(nvec[1] > 0, O, 2 * np.pi - O)
        W = vf.arccos(nvec.normalized().dot(evec.normalized()))
        W = vf.ifelse(evec[2] > 0, W, 2 * np.pi - W)
        return vf.stack([a, e, i, O, W]) - np.array([at, et, it, Ot, Wt])

    at, et = 24361140 / Lstar, .7308
    Ot, Wt = np.deg2rad(269.8), np.deg2rad(130.5)
    istart = np.deg2rad(28.5)
    y0 = np.zeros(6)
    y0[0:3] = np.array([np.cos(istart), 0, np.sin(istart)]) * Re
    y0[3:6] = -np.cross(y0[0:3], np.array([0, 0, We]))
    y0[3] += 0.00001 / Vstar
    yf = ast.Astro.classic_to_cartesian([at, et, istart, Ot, Wt, -.05], mu)

    ts = np.linspace(0, tf_phase[3], 1000)
    IGs = [[], [], [], []]
    bounds_t = [0] + tf_phase
    for t in ts:
        X = np.zeros(11)
        X[0:6] = y0 + (yf - y0) * (t / ts[-1])
        X[7] = t
        X[8:11] = [0, 1, 0]
        for ph in range(4):
            if bounds_t[ph] <= t < bounds_t[ph + 1] or \
                    (ph == 3 and t >= bounds_t[4]):
                frac = (t - bounds_t[ph]) / (bounds_t[ph + 1] - bounds_t[ph])
                X[6] = m0_phase[ph] + (mf_phase[ph] - m0_phase[ph]) * frac
                IGs[ph].append(X.copy())
                break

    phases = []
    for i in range(4):
        p = RocketODE(T_phase[i], mdot_phase[i]).phase("LGL3", IGs[i],
                                                        nsegs)
        p.setControlMode("HighestOrderSpline")
        p.addLUNormBound("Path", [8, 9, 10], .5, 1.5)
        if i == 0:
            p.addBoundaryValue("Front", range(0, 8), IGs[0][0][0:8])
            p.addLowerNormBound("Path", [0, 1, 2], Re * .999999)
        else:
            p.addLowerNormBound("Path", [0, 1, 2], Re)
            p.addBoundaryValue("Front", [6], [m0_phase[i]])
        if i < 3:
            p.addBoundaryValue("Back", [7], [tf_phase[i]])
        phases.append(p)
    phases[3].addUpperVarBound("Back", 7, tf_phase[3], 1.0)
    phases[3].addEqualCon("Back", target_orbit(at, et, istart, Ot, Wt),
                          range(0, 6))
    phases[3].addValueObjective("Back", 6, -1.0)

    ocp = oc.OptimalControlProblem()
    for p in phases:
        ocp.addPhase(p)
    ocp.addForwardLinkEqualCon(phases[0], phases[3],
                               [0, 1, 2, 3, 4, 5, 7, 8, 9, 10])
    ocp.optimizer.set_OptLSMode("L1")
    ocp.optimizer.set_SoeLSMode("L1")
    ocp.optimizer.set_MaxLSIters(2)
    if adaptive:
        ocp.setAdaptiveMesh(True)
        for p in phases:
            p.MeshTol = 1e-7
            p.MaxMeshIters = 4
            p.MeshErrorEstimator = "deboor"
    return ocp, phases


def two_body_ode(ast):
    """The two-body problem (mu = 1), rows [r, v, t]."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class TwoBody(oc.ODEBase):
        def __init__(self):
            a = oc.ODEArguments(6, 0)
            R, V = a.XVec().head3(), a.XVec().tail3()
            super().__init__(vf.stack(V, -1.0 * R.normalized_power3()), 6)
    return TwoBody()


def two_body_rows(n, seed=11):
    """Seeded bound two-body rows [r, v, t0 = 0] (eccentricity up to about
    0.3, any inclination) and the period of each."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 7))
    r = 1.0 + 0.2 * rng.uniform(-1, 1, n)
    rows[:, 0] = r
    speed = np.sqrt(1.0 / r) * (1.0 + 0.15 * rng.uniform(-1, 1, n))
    ang = rng.uniform(0, 2 * np.pi, n)
    fpa = 0.2 * rng.uniform(-1, 1, n)
    rows[:, 3] = speed * np.sin(fpa)
    rows[:, 4] = speed * np.cos(fpa) * np.cos(ang)
    rows[:, 5] = speed * np.cos(fpa) * np.sin(ang)
    a = 1.0 / (2.0 / r - speed ** 2)
    return rows, 2 * np.pi * a ** 1.5


def build_hypersens(ast):
    """The hypersensitive problem of `tests/test_adaptivemesh.py`: LGL7,
    10 segments to start, tf = 10000, adaptive mesh with MeshTol 1e-6 and
    the default "integrator" estimator."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class HyperSens(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(1, 1)
            super().__init__(-XtU.XVar(0) + XtU.UVar(0), 1, 1)

    xt0, xtf, tf = 1.5, 1.0, 10000.0
    IG = [[xt0 * (1 - t / tf) + xtf * (t / tf), t, 0]
          for t in np.linspace(0, tf, 1000)]
    phase = HyperSens().phase("LGL7", IG, 10)
    phase.addBoundaryValue("First", [0, 1], [xt0, 0])
    phase.addBoundaryValue("Last", [0, 1], [xtf, tf])
    phase.addIntegralObjective(vf.Arguments(2).squared_norm() / 2, [0, 2])
    phase.addLUVarBound("Path", 0, -50, 50)
    phase.addLUVarBound("Path", 2, -50, 50)
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_SoeLSMode("L1")
    phase.setAdaptiveMesh(True)
    phase.setMeshTol(1.0e-6)
    phase.setMaxMeshIters(8)
    return phase


def build_multispacecraft(ast, nsegs=12):
    """The low-thrust rendezvous leg of the MultiSpacecraft ensemble
    (`examples/MultiSpacecraftOptimization.py`, `ensemble_demo`): a
    two-body phase with a 3-component thrust acceleration, LGL3 on 12
    segments (10 variables a node), from a circular orbit to a target 4
    degrees ahead of the half-revolution point, minimizing the integral of
    the squared thrust; built with either package's namespace."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments

    class TwoBody(oc.ODEBase):
        def __init__(self, ltacc=0.0):
            args = oc.ODEArguments(6, 3 if ltacc else 0)
            r, v = args.head3(), args.segment3(3)
            acc = r.normalized_power3() * (-1.0)
            if ltacc:
                acc = acc + args.tail3() * ltacc
            super().__init__(vf.stack([v, acc]), 6, 3 if ltacc else 0)

    def circ(r, thetadeg):
        v, th = np.sqrt(1.0 / r), np.deg2rad(thetadeg)
        return np.array([np.cos(th) * r, np.sin(th) * r, 0.0,
                         -np.sin(th) * v, np.cos(th) * v, 0.0, 0.0])

    rows = TwoBody().integrator(.01).integrate_dense(circ(1, 0.0), np.pi, 40)
    IG = [np.concatenate([np.asarray(row)[:7], [0.01, 0, 0]]) for row in rows]
    target = circ(1.0, np.rad2deg(np.pi) + 4.0)
    phase = TwoBody(ltacc=0.05).phase("LGL3", IG, nsegs)
    phase.addBoundaryValue("Front", range(0, 7), np.asarray(IG[0][:7]))
    phase.addUpperNormBound("Path", [7, 8, 9], 1.0)
    phase.addBoundaryValue("Back", [6], [np.pi])
    phase.addEqualCon("Back", Args(6) - target[0:6], range(0, 6))
    phase.addIntegralObjective(Args(3).squared_norm(), [7, 8, 9])
    return phase


def build_dionysus(ast, nsegs=150):
    """The mass-optimal Earth to Dionysus low-thrust transfer of
    `examples/DionysusLowThrust.py` (modified equinoctial elements and a
    constant-specific-impulse thruster, `Astro.MEETwoBody_CSI`; LGL5 with
    block-constant controls, AUGLANG line searches), built with either
    package's namespace.  The final mass in kg is the last state's mass
    times `DIONYSUS_MASS`."""
    A, c = ast.Astro, ast.Astro.Constants
    thruster = A.CSIThruster(.32, 3000, DIONYSUS_MASS)
    ode = A.MEETwoBody_CSI(c.MuSun, c.AU, thruster)
    tf = 3534 * c.day / ode.tstar
    X0 = np.array([0.99969, -0.00376, 0.01628, -7.702e-6, 6.188e-7, 14.161])
    XF = np.array([1.5536, 0.15303, -0.51994, 0.01618, 0.11814, 46.3302])
    first = np.zeros(8)
    first[0:6], first[6] = X0, 1
    IG = []
    for t in np.linspace(0, tf, 500):
        row = np.zeros(11)
        row[0:6] = X0 + (XF - X0) * t / tf
        row[6], row[7], row[9] = 1, t, .5
        IG.append(row)
    phase = ode.phase("LGL5", IG, nsegs)
    phase.setControlMode("BlockConstant")
    phase.addBoundaryValue("Front", range(0, 8), first)
    phase.addLUNormBound("Path", range(8, 11), .000001, 1, 1)
    phase.addBoundaryValue("Back", [7], [tf])
    phase.addBoundaryValue("Back", range(0, 6), XF[0:6])
    phase.addValueObjective("Back", 6, -1.0)
    opt = phase.optimizer
    opt.set_OptLSMode("AUGLANG")
    opt.set_MaxLSIters(2)
    opt.set_MaxAccIters(200)
    opt.set_BoundFraction(.997)
    opt.set_deltaH(1.0e-6)
    opt.set_EContol(1.0e-9)
    return phase


# The supersonic climb's tables (`examples/MinimumTimeToClimbTables.py`:
# F-4 aero coefficients against Mach, the 1976 standard atmosphere, thrust
# against Mach and altitude)
CLIMB_AERO_MACH = [0, 0.4, .6, .75, 0.8, 0.9, 1.0, 1.2, 1.4, 1.6, 1.8]
CLIMB_CLALPHA = [3.44, 3.44, 3.44, 3.44, 3.44, 3.58, 4.44, 3.44, 3.01, 2.86,
                 2.44]
CLIMB_CD0 = [.013, .013, .013, .013, .013, .014, .031, .041, .039, .036,
             .035]
CLIMB_ETA = [0.54, 0.54, 0.54, 0.54, 0.54, 0.75, 0.79, 0.78, 0.89, 0.93,
             0.93]
CLIMB_RHO = [1.478e+00, 1.225e+00, 1.007e+00, 8.193e-01, 6.601e-01,
             5.258e-01, 4.135e-01, 3.119e-01, 2.279e-01, 1.665e-01,
             1.216e-01, 8.891e-02, 6.451e-02, 4.694e-02, 3.426e-02,
             2.508e-02, 1.841e-02, 1.355e-02, 9.887e-03, 7.257e-03,
             5.366e-03, 3.995e-03, 2.995e-03, 2.259e-03, 1.714e-03,
             1.317e-03, 1.027e-03, 8.055e-04, 6.389e-04, 5.044e-04,
             3.962e-04, 3.096e-04, 2.407e-04, 1.860e-04, 1.429e-04,
             1.091e-04, 8.281e-05, 6.236e-05, 4.637e-05, 3.430e-05,
             2.523e-05, 1.845e-05, 1.341e-05, 9.690e-06, 6.955e-06]
CLIMB_SOS = [347.9, 340.3, 332.5, 324.6, 316.5, 308.1, 299.5, 295.1, 295.1,
             295.1, 295.1, 295.1, 296.4, 297.7, 299.1, 300.4, 301.7, 303.0,
             306.5, 310.1, 313.7, 317.2, 320.7, 324.1, 327.5, 329.8, 329.8,
             328.8, 325.4, 322.0, 318.6, 315.1, 311.5, 308.0, 304.4, 300.7,
             297.1, 293.4, 290.7, 288.0, 285.3, 282.5, 279.7, 276.9, 274.1]
CLIMB_THRUST_MACH = [0, 0.2, 0.4, 0.6, 0.8, 1, 1.2, 1.4, 1.6, 1.8]
CLIMB_THRUST_ALT = [-.5, 0, 5, 10, 15, 20, 25, 30, 40, 50, 70]   # 1000 ft
CLIMB_THRUST = [                                                # 1000 lbf
    [24.2, 24.2, 24.0, 20.3, 17.3, 14.5, 12.2, 10.2, 5.7, 3.4, 0.1],
    [28.0, 28.0, 24.6, 21.1, 18.1, 15.2, 12.8, 10.7, 6.5, 3.9, 0.2],
    [28.3, 28.3, 25.2, 21.9, 18.7, 15.9, 13.4, 11.2, 7.3, 4.4, 0.4],
    [30.8, 30.8, 27.2, 23.8, 20.5, 17.3, 14.7, 12.3, 8.1, 4.9, 0.8],
    [34.5, 34.5, 30.3, 26.6, 23.2, 19.8, 16.8, 14.1, 9.4, 5.6, 1.1],
    [37.9, 37.9, 34.3, 30.4, 26.8, 23.3, 19.8, 16.8, 11.2, 6.8, 1.4],
    [36.1, 36.1, 38.0, 34.9, 31.3, 27.3, 23.6, 20.1, 13.4, 8.3, 1.7],
    [36.1, 36.1, 36.6, 38.5, 36.1, 31.6, 28.1, 24.2, 16.2, 10.0, 2.2],
    [36.1, 36.1, 35.2, 42.1, 38.7, 35.7, 32.0, 28.1, 19.3, 11.9, 2.9],
    [36.1, 36.1, 33.8, 45.7, 41.3, 39.8, 34.6, 31.1, 21.7, 13.3, 3.1]]


def build_climb(ast, nsegs=50):
    """The supersonic minimum time to climb of `examples/MinimumTimeToClimb.py`
    (LGL5, HighestOrderSpline controls), its dynamics closed over the
    example's cubic 1-D and 2-D `vf.InterpTable` tables, built with either
    package's namespace.  The objective is the climb time in units of 250
    s."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    alts = np.arange(-2000.0, 86001.0, 2000.0)
    rhoTab = vf.InterpTable1D(alts, CLIMB_RHO, kind="cubic")
    sosTab = vf.InterpTable1D(alts, CLIMB_SOS, kind="cubic")
    ClalphaTab = vf.InterpTable1D(CLIMB_AERO_MACH, CLIMB_CLALPHA,
                                  kind="cubic")
    etaTab = vf.InterpTable1D(CLIMB_AERO_MACH, CLIMB_ETA, kind="cubic")
    CD0Tab = vf.InterpTable1D(CLIMB_AERO_MACH, CLIMB_CD0, kind="cubic")
    ThrustTab = vf.InterpTable2D(
        CLIMB_THRUST_MACH, 304.8 * np.array(CLIMB_THRUST_ALT),
        4448.2 * np.array(CLIMB_THRUST).T, kind="cubic")
    g0, Lstar, Tstar, Mstar = 9.80665, 10000, 250.0, 19050.864
    Vstar, Rhostar = Lstar / Tstar, Mstar / Lstar ** 3
    Fstar = Lstar / Tstar ** 2 * Mstar
    mu = 3.986012e14 / (Lstar ** 3 / Tstar ** 2)
    Re, S = 6378145 / Lstar, 49.2386 / Lstar ** 2
    vexhaust = 1600 * g0 / Vstar

    class AirPlane(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(4, 1)
            h, v, fpa, mass = XtU.XVec().tolist()
            alpha = XtU.UVar(0)
            rho = rhoTab(h * Lstar) / Rhostar
            Mach = v / (sosTab(h * Lstar) / Vstar)
            Clalpha = ClalphaTab(Mach)
            Thrust = ThrustTab(Mach, h * Lstar) / Fstar
            CD = CD0Tab(Mach) + etaTab(Mach) * Clalpha * (alpha ** 2)
            q = 0.5 * rho * (v ** 2)
            D, L = q * S * CD, q * S * Clalpha * alpha
            r = h + Re
            super().__init__(vf.stack([
                v * vf.sin(fpa),
                (Thrust * vf.cos(alpha) - D) / mass
                - mu * vf.sin(fpa) / (r ** 2),
                (Thrust * vf.sin(alpha) + L) / (mass * v)
                + vf.cos(fpa) * (v / r - mu / (v * (r ** 2))),
                -Thrust / vexhaust]), 4, 1)

    ht0, htf = .010 / Lstar, 19994.88 / Lstar
    vt0, vtf = 129.314 / Vstar, 295.092 / Vstar
    mass0 = 19050.864 / Mstar
    XtU0 = np.array([ht0, vt0, 0, mass0, 0, 0])
    XtUf = np.array([htf, vtf, 0, mass0, 200 / Tstar, 0])
    IG = [XtU0 * (1 - t) + XtUf * t for t in np.linspace(0, 1, 100)]
    phase = AirPlane().phase("LGL5", IG, nsegs)
    phase.setControlMode("HighestOrderSpline")
    phase.addBoundaryValue("First", range(0, 5), [ht0, vt0, 0, mass0, 0])
    phase.addLUVarBound("Path", 0, 0, 21000.0 / Lstar)
    phase.addLUVarBound("Path", 1, 5 / Vstar, 600 / Vstar)
    phase.addLUVarBound("Path", 2, -20 * np.pi / 180, 40 * np.pi / 180)
    phase.addLowerVarBound("Last", 3, 16500 / Mstar)
    phase.addLUVarBound("Path", 5, -np.pi / 4, np.pi / 4)
    phase.addBoundaryValue("Last", range(0, 3), [htf, vtf, 0])
    phase.addDeltaTimeObjective(1.0)
    return phase


def kepler_family(ast, **kw):
    """A family row [E_guess, e, M] -> two functions of the root E of
    Kepler's equation E - e sin E = M (`vf.ScalarRootFinder`), built with
    either package's namespace."""
    vf = ast.VectorFunctions
    X = vf.Arguments(3)
    rf = vf.ScalarRootFinder(X[0] - X[1] * vf.sin(X[0]) - X[2], **kw)
    return vf.stack([rf * X[2] + X[1] ** 2 * rf,
                     vf.sin(rf * X[1]) + rf * rf])


def kepler_rows(n, seed=21):
    """Seeded rows [M, e, M] of `kepler_family` (e up to 0.8) and
    multipliers in [-1, 1] for its adjoint Hessians; the first rows of a
    larger draw are the rows of a smaller one."""
    u = np.random.default_rng(seed).random((n, 4))
    e, M = 0.8 * u[:, 0], np.pi * (2 * u[:, 1] - 1)
    return np.stack([M, e, M], axis=1), 2 * u[:, 2:] - 1


# Heliocentric elements [a (AU), e, i, RAAN, argp, M at t = 0] of Earth and
# Mars (J2000 ecliptic, rounded), mu = 1: one time unit is 58.13 days
EARTH_OE = [1.00000261, 0.01671123, 0.0, 0.0, 1.79676742, -0.04333]
MARS_OE = [1.52371034, 0.09339410, 0.03228, 0.86495, 5.00040, 0.33800]


def orbit_positions(oe, ts):
    """Positions (n, 3) at times ts on the Keplerian orbit with elements
    oe (mu = 1), from Kepler's equation in numpy: the same inputs for
    either package."""
    a, e, i, raan, argp, M0 = oe
    M = M0 + np.asarray(ts, float) * a ** -1.5
    E = M.copy()
    for _ in range(30):
        E = E - (E - e * np.sin(E) - M) / (1 - e * np.cos(E))
    cO, sO, co, so, ci, si = (np.cos(raan), np.sin(raan), np.cos(argp),
                              np.sin(argp), np.cos(i), np.sin(i))
    P = np.array([cO * co - sO * so * ci, sO * co + cO * so * ci, so * si])
    Q = np.array([-cO * so - sO * co * ci, -sO * so + cO * co * ci, co * si])
    x, y = a * (np.cos(E) - e), a * np.sqrt(1 - e * e) * np.sin(E)
    return x[:, None] * P + y[:, None] * Q


def porkchop(ndep=512, ntof=512):
    """An Earth to Mars porkchop grid: ndep departure dates over 27 time
    units (4.3 years) x ntof times of flight from 1.5 to 8 time units (87 to
    465 days).  Returns (r1, r2, tof), one row a transfer, departure-major."""
    dep = np.linspace(0.0, 27.0, ndep)
    tof = np.linspace(1.5, 8.0, ntof)
    r1 = np.repeat(orbit_positions(EARTH_OE, dep), ntof, axis=0)
    arrive = (dep[:, None] + tof[None, :]).ravel()
    return r1, orbit_positions(MARS_OE, arrive), np.tile(tof, ndep)


def conic_residuals(r1, v1, r2, v2, tof):
    """How far each transfer (r1, v1) -> (r2, v2) in time tof (mu = 1) is
    from a two-body arc, in numpy, without a propagator or a Lambert
    solver: the time of flight from Kepler's equation between the two
    ends' mean anomalies (elliptic lanes modulo one period) less tof, and
    the differences of the angular momentum, the energy and the
    eccentricity vector between the two ends.  Returns the lanes' largest
    of the four."""
    h1, h2 = np.cross(r1, v1), np.cross(r2, v2)
    R1, R2 = np.linalg.norm(r1, axis=1), np.linalg.norm(r2, axis=1)
    en1 = 0.5 * (v1 * v1).sum(1) - 1 / R1
    en2 = 0.5 * (v2 * v2).sum(1) - 1 / R2
    e1 = np.cross(v1, h1) - r1 / R1[:, None]
    e2 = np.cross(v2, h2) - r2 / R2[:, None]
    a, e = -0.5 / en1, np.linalg.norm(e1, axis=1)
    ell = a > 0
    sa = np.sqrt(np.abs(a))

    def mean_anomaly(r, v, R):
        with np.errstate(invalid="ignore"):
            E = np.arctan2((r * v).sum(1) / sa, 1 - R / a)
            H = np.arcsinh((r * v).sum(1) / (e * sa))
        return np.where(ell, E - e * np.sin(E), e * np.sinh(H) - H)
    dM = mean_anomaly(r2, v2, R2) - mean_anomaly(r1, v1, R1)
    dM = np.where(ell, np.mod(dM, 2 * np.pi), dM)
    return np.max([np.abs(dM * sa ** 3 - tof), np.abs(h1 - h2).max(1),
                   np.abs(en1 - en2), np.abs(e1 - e2).max(1)], axis=0)


def porkchop_lanes(n=64, seed=31, total=512 * 512):
    """The seeded lanes of the full grid held against the JAX package."""
    return np.sort(np.random.default_rng(seed).choice(total, n,
                                                      replace=False))


def quasi_definite_blocks(K, W, seed, dtype):
    """Seeded symmetric quasi-definite blocks: a positive definite
    leading half and a negative definite trailing half, as the
    regularized KKT macro-blocks are."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, W, W))
    A = (A + A.transpose(0, 2, 1)) / 2
    h = (W + 1) // 2
    A[:, :h, :h] += W * np.eye(h)
    A[:, h:, h:] -= W * np.eye(W - h)
    return torch.tensor(A, dtype=dtype, device="cuda")


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls=10, reps=20):
    """Device time of one fn(): `calls` calls captured into a CUDA graph,
    median of `reps` CUDA-event timings of a replay, over `calls`.  The
    replay has no host work between launches, so a kernel that is shorter
    than its wrapper's host time is still timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


# H100 SXM data sheet: device memory rate, and the card's peak rates for
# the type: FP64 through the tensor cores (mma.sync DMMA; K1's plain FMAs
# can reach half of it), FP32 outside them
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}


def k1_bound(K, W, dtype):
    """Least time (ms) the card could take for K1 on a (K, W, W) batch: the
    larger of the bytes moved once (block in, inverse and pivots and
    counts out) over the memory rate and 2 W^3 operations a block over the
    peak rate.  Returns (bound_ms, "bytes" or "operations")."""
    size = torch.finfo(dtype).bits // 8
    t_bytes = (K * W * (2 * W + 1) * size + 4 * K) / PEAK_BYTES
    t_ops = 2.0 * K * W ** 3 / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def plain_inertia(ck, D):
    """The plain count of bad pivots and the zeroed inverse, from the
    unblocked plain elimination on D's device."""
    X, p = ck.gj_inverse_ref(D)
    tiny = 1e-25 if D.dtype == torch.float32 else 1e-250
    nbad = ((p < 0) | ~torch.isfinite(p) | (p.abs() < tiny)).sum(1)
    return torch.where(torch.isfinite(X), X, torch.zeros_like(X)), p, nbad


# (K, W) at which K1 is held against its plain versions, and the f64
# shapes at which it is timed: the BCR levels of the 10^4-node problems
# (W 24 and 25), the other widths of the solves below, both ends of each
# kernel's range, and the borders of 80 to 1024 segments a phase
K1_SHAPES = [(2500, 24), (1250, 24), (156, 24), (1, 24), (5002, 25),
             (2501, 25), (1, 1), (1, 2), (514, 8), (25, 11), (13, 27), (3, 32), (3, 33),
             (65, 42), (3, 64), (1, 65), (1, 85), (1, 160), (1, 255),
             (1, 261), (2, 511), (1, 517), (1, 1029), (40000, 24),
             (3072, 22), (512, 3), (500, 45)]
# then: the first reduction level of the 16-lane CartPole ensemble (16 x
# 2500 blocks), the first level and the border of the 512-lane
# MultiSpacecraft ensemble (512 x 6 blocks, 512 borders), and the first
# level of the Dionysus transfer at 1000 segments (phase 18)
K1_TIMED = [(2500, 24), (156, 24), (1, 24), (5002, 25), (2501, 25),
            (514, 8), (25, 11), (1, 255), (1, 261), (1, 517), (1, 1029),
            (40000, 24), (3072, 22), (512, 3), (500, 45)]
# the shape of each kernel's entry in the kernels line, and the run that
# its launches are read from: the first reduction level of Delta III at
# 10,004 nodes, the border of formation flying at 256 segments
K1_MAIN = {(5002, 25): ("gj_inverse", "Delta III, 10,004 nodes"),
           (1, 261): ("gj_inverse_wide", "formation flying, 256 segments")}


def k1_time(ck, D, err):
    """K1's device time on D (graph replay), a wrapper call's time, the
    bound, the plain version's and `torch.linalg.inv_ex`'s times; err is
    the largest deviation from the plain version, measured by the
    caller."""
    K, W = D.shape[:2]
    bound, by = k1_bound(K, W, D.dtype)
    m = dict(max_abs_err=err,
             ms=graph_ms(lambda: ck.gj_inverse_inertia(D)),
             call_ms=cuda_ms(lambda: ck.gj_inverse_inertia(D)),
             plain_ms=cuda_ms(lambda: ck.gj_inverse_ref(D), reps=5),
             bound_ms=bound, bound_by=by,
             library_ms=cuda_ms(lambda: torch.linalg.inv_ex(D)))
    print(f"  timing ({K},{W},{W}) f64: kernel {m['ms']:.5f} ms "
          f"on the device (graph replay), {m['call_ms']:.5f} ms "
          f"a wrapper call; bound {bound:.6f} ms by {by} "
          f"({100 * bound / m['ms']:.2f}% of the kernel's time); plain "
          f"{m['plain_ms']:.4f} ms; torch.linalg.inv_ex "
          f"{m['library_ms']:.4f} ms")
    return m


def phase_kernel(ck):
    """Phase 3: K1 (narrow kernels up to W = 64, the blocked wide kernel
    above) against its plain versions, f64 and f32.  Tolerances: 1e-12
    (f64) and 1e-4 (f32) relative on the inverse and on the pivots, and
    equal pivot signs; the wide kernel's pivots are sums taken in another
    order than the unblocked plain version's, so they are equal to
    rounding, not bitwise.  Returns the f64 measurements by (K, W)."""
    out = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for i, (K, W) in enumerate(K1_SHAPES):
            D = quasi_definite_blocks(K, W, seed=100 + i, dtype=dtype)
            n0, w0 = ck.gj_inverse.launches, ck.gj_inverse.wide_launches
            X, p = ck.gj_inverse(D)
            wide = W > ck.MAX_W
            check((ck.gj_inverse.wide_launches - w0,
                   ck.gj_inverse.launches - n0) == ((1, 0) if wide
                                                    else (0, 1)),
                  f"K1 at width {W} did not launch the expected kernel")
            Xi, pi, nbad = ck.gj_inverse_inertia(D)
            X2, p2, nbad2 = ck.gj_inverse_inertia(D)
            torch.cuda.synchronize()
            Xr, pr, nbad_r = plain_inertia(ck, D)
            ex, ep = rel(X, Xr), rel(p, pr)
            signs = bool(torch.equal(torch.sign(p), torch.sign(pr)))
            same = all(torch.equal(a, b) for a, b in
                       ((X, Xi), (p, pi), (Xi, X2), (pi, p2), (nbad, nbad2)))
            note = ""
            if wide:
                Xb, pb = ck.gj_inverse_blocked_ref(D)
                eb = max(rel(X, Xb), rel(p, pb))
                note = f"  blocked plain rel {eb:.3e}"
                check(eb <= tol, f"wide K1 disagrees with the blocked plain "
                      f"version at ({K},{W}) {dtype}")
            print(f"K1{' wide' if wide else ''} {str(dtype)[6:]} "
                  f"({K},{W},{W}): inverse rel {ex:.3e}  pivots rel "
                  f"{ep:.3e}{note}  signs equal {signs}  bad pivots "
                  f"{int(nbad.sum())} (plain {int(nbad_r.sum())})  second "
                  f"run bitwise equal {same}")
            check(ex <= tol and ep <= tol and signs,
                  f"K1 disagrees with its plain version at ({K},{W}) "
                  f"{dtype}")
            check(torch.equal(nbad.long(), nbad_r),
                  f"K1 bad-pivot count off at ({K},{W}) {dtype}")
            check(same, f"K1 not bitwise repeatable at ({K},{W}) {dtype}")
            if dtype == torch.float64 and (K, W) in K1_TIMED:
                out[(K, W)] = k1_time(ck, D, float((X - Xr).abs().max()))

        # a block with a zero pivot and a NaN pivot among clean ones
        for W in (24, 40, 70, 261):
            D = quasi_definite_blocks(3, W, seed=7, dtype=dtype)
            zero, nan = W // 3, W // 2
            D[1, [zero, nan], :] = 0.0
            D[1, :, [zero, nan]] = 0.0
            D[1, nan, nan] = float("nan")
            X, p, nbad = ck.gj_inverse_inertia(D)
            torch.cuda.synchronize()
            Xr, pr, nbad_r = plain_inertia(ck, D)
            print(f"K1 {str(dtype)[6:]} (3,{W},{W}) with a zero and a NaN "
                  f"pivot: bad pivots {nbad.tolist()} (plain "
                  f"{nbad_r.tolist()}), inverse rel {rel(X, Xr):.3e}")
            check(torch.equal(nbad.long(), nbad_r)
                  and float(p[1, zero]) == 0.0
                  and bool(torch.isnan(p[1, nan]))
                  and bool(torch.isfinite(X).all()) and rel(X, Xr) <= tol,
                  f"K1 inertia epilogue off at width {W} {dtype}")
    return out


def print_ptxas(ck):
    """What ptxas -v reported for the built kernels: the totals, and the
    lines of the instances the solves below launch most."""
    want = ("Li8E", "Li12E", "Li24E", "Li28E", "Li44E", "Li64E", "panel",
            "update")
    for log in ck.build.logs:
        with open(log) as f:
            txt = f.read()
        names = re.findall(r"Compiling entry function '(\S+)'", txt)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", txt)]
        spill = [tuple(map(int, m)) for m in re.findall(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads", txt)]
        print(f"ptxas {log.rsplit('/', 1)[-1]}: {len(names)} kernels, "
              f"registers up to {max(regs)}, stack frame up to "
              f"{max(s[0] for s in spill)} B, spill stores up to "
              f"{max(s[1] for s in spill)} B")
        for n, r, sp in zip(names, regs, spill):
            if any(w in n for w in want):
                print(f"  {n}: {r} registers, stack/spill stores/loads {sp}")


def phase_bcr(kb):
    """Phase 4: bcr_factor/bcr_solve at (K=64, W=24, b=2)."""
    K, W, b = 64, 24, 2
    for seed, spd in ((0, True), (1, False), (2, False)):
        rng = np.random.default_rng(seed)
        diag = rng.normal(size=(K, W, W))
        diag = (diag + diag.transpose(0, 2, 1)) / 2
        if spd:
            diag += W * np.eye(W)
        lower = rng.normal(size=(K, W, W)) * 0.3
        lower[-1] = 0.0
        B = rng.normal(size=(K, W, b)) * 0.2
        C = rng.normal(size=(b, b))
        C = (C + C.T) / 2 - b * np.eye(b)
        A = np.zeros((K * W + b, K * W + b))
        for k in range(K):
            A[k * W:(k + 1) * W, k * W:(k + 1) * W] = diag[k]
            if k + 1 < K:
                A[(k + 1) * W:(k + 2) * W, k * W:(k + 1) * W] = lower[k]
                A[k * W:(k + 1) * W, (k + 1) * W:(k + 2) * W] = lower[k].T
            A[k * W:(k + 1) * W, K * W:] = B[k]
            A[K * W:, k * W:(k + 1) * W] = B[k].T
        A[K * W:, K * W:] = C
        t = [torch.tensor(a, dtype=torch.float64, device="cuda")
             for a in (diag, lower, B, C, A)]
        fac, neigs = kb.bcr_factor(*(a[None] for a in t[:4]))
        neigs = neigs[0]
        At = t[4]
        r = torch.tensor(rng.normal(size=(K, W)), dtype=torch.float64,
                         device="cuda")
        rb = torch.tensor(rng.normal(size=(b,)), dtype=torch.float64,
                          device="cuda")
        y, z = (a[0] for a in kb.bcr_solve(fac, r[None], rb[None]))
        ref = torch.linalg.solve(At, torch.cat([r.reshape(-1), rb]))
        err = rel(torch.cat([y.reshape(-1), z]), ref)
        nneg = int((torch.linalg.eigvalsh(At) < 0).sum())
        print(f"BCR (64,24,2) seed {seed}: solve rel {err:.3e}, inertia "
              f"{int(neigs)} vs eigvalsh {nneg}")
        check(err < 1e-8, "BCR solve disagrees with the dense solve")
        check(int(neigs) == nneg, "BCR inertia disagrees with eigvalsh")


def reset_peak_memory():
    """Start a peak-memory reading: the problems of earlier phases are
    collected first, so that the peak is this problem's alone."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def run_phase(ast, ck, nsegs):
    ph = build_cartpole(ast, nsegs)
    ph.optimizer.set_PrintLevel(1)
    ph.optimizer.UseFused = False       # held to the JAX host loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ph.transcribe()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ck.gj_inverse.launches = 0
    flag = ph.optimize()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ck.gj_inverse.launches
    traj = np.asarray(ph.returnTraj())
    check(traj.shape == (ph.numNodes, 6) and np.isfinite(traj).all(),
          "trajectory is not finite or has the wrong shape")
    return ph, flag, launches, t1 - t0, t2 - t1


def phase_slice40(ast, ck):
    """Phase 5: 40 segments against the JAX package's CPU result, and a
    bitwise repeatability check of the factorization."""
    ph, flag, launches, _, _ = run_phase(ast, ck, 40)
    opt = ph.optimizer
    it, obj = opt.LastIterNum, opt.LastObjVal
    print(f"slice 40 segs: flag {flag} iters {it} obj {obj:.15f} "
          f"K1 launches {launches}")
    check(flag == 0, "40-segment solve did not converge")
    check(abs(it - 10) <= 1, "40-segment iteration count off")
    check(abs(obj - OBJ_40) <= 1e-7 * OBJ_40, "40-segment objective off")
    check(launches > 0, "40-segment solve never launched K1")

    check_repeatable_factor(opt, ph.makeSolverInput())


def check_repeatable_factor(opt, x):
    """Factor the final iterate twice: the two factors must be bitwise
    equal (gather-table assembly, no atomics)."""
    kkt = opt.kkt
    x = torch.tensor(x, dtype=torch.float64, device="cuda")
    lamE, lamI, s = (torch.tensor(a, dtype=torch.float64, device="cuda")
                     for a in (opt.LastEqLmults, opt.LastIqLmults,
                               opt.LastSlacks))
    sig_tilde = lamI / s.clamp_min(1e-12)
    facs = [kkt.factor(x, lamE, lamI, 1.0, sig_tilde, 0.0, opt.gammaE)
            for _ in range(2)]

    def flat(f):
        out = [f["D0inv"], f["B0"], f["Cinv"]] + list(f["iq_jx"])
        for lev in f["levels"]:
            out += [lev["Dinv"], lev["L_le"], lev["L_er"], lev["B_odd"]]
        return out
    same = facs[0][1] == facs[1][1] and all(
        torch.equal(a, b) for a, b in zip(flat(facs[0][0]), flat(facs[1][0])))
    print(f"factor of one iterate twice: bitwise equal {same}")
    check(same, "factorization is not bitwise repeatable")


def phase_slice5000(ast, ck):
    """Phase 6: the 10,001-node problem."""
    reset_peak_memory()
    ph, flag, launches, t_setup, t_solve = run_phase(ast, ck, 5000)
    opt = ph.optimizer
    it, obj = opt.LastIterNum, opt.LastObjVal
    peak = torch.cuda.max_memory_allocated()
    bs = opt.kkt.bs
    print(f"slice 5000 segs ({ph.numNodes} nodes, K {bs.K} W {bs.W} "
          f"b {bs.b}): flag {flag} iters {it} obj {obj:.15f}")
    print(f"  transcription {t_setup:.3f} s, optimize (time-to-solution) "
          f"{t_solve:.3f} s, {it / t_solve:.3f} iterations/s, peak device "
          f"memory {peak / 2**20:.1f} MiB, K1 launches {launches}")
    print(f"  host-clock split of optimize: function evaluation "
          f"{opt.LastFuncTime:.3f} s, KKT factor+solve {opt.LastKKTTime:.3f} s")
    check(flag == 0, "10,001-node solve did not converge")
    check(abs(obj - OBJ_5000) <= 1e-6 * OBJ_5000,
          "10,001-node objective off")
    check(launches > 0, "10,001-node solve never launched K1")
    return obj


def counted(ck, fn):
    """Run fn() with the K1 launch counts set to 0 just before it; returns
    (fn's result, narrow launches, wide launches, seconds)."""
    torch.cuda.synchronize()
    ck.gj_inverse.launches = 0
    ck.gj_inverse.wide_launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, ck.gj_inverse.launches, ck.gj_inverse.wide_launches,
            time.perf_counter() - t0)


def phase_breadth(ast, ck):
    """Phase 7: single-phase breadth, every transcription and the
    BlockConstant / HighestOrderSpline control modes."""
    cases = [("Brachistochrone", tm, build_brachistochrone(ast, tm, 24), ref)
             for tm, ref in BRACH_24.items()]
    cases += [("CartPole LGL5 128", cm, build_cartpole(ast, 128, "LGL5", cm),
               ref) for cm, ref in CARTPOLE_128.items()]
    for prob, mode, ph, (rflag, rit, robj) in cases:
        ph.optimizer.set_PrintLevel(2)
        ph.optimizer.UseFused = False   # held to the JAX host loop
        flag, n1, _, secs = counted(ck, ph.optimize)
        it, obj = ph.optimizer.LastIterNum, ph.optimizer.LastObjVal
        bs = ph.optimizer.kkt.bs
        print(f"{prob} {mode}: flag {flag} iters {it} obj {obj:.15f} "
              f"(K {bs.K} W {bs.W} b {bs.b}) K1 launches {n1}, "
              f"{secs:.3f} s")
        check(flag == rflag, f"{prob} {mode}: flag {flag}")
        check(abs(it - rit) <= 1, f"{prob} {mode}: iterations {it}")
        check(abs(obj - robj) <= 1e-7 * abs(robj),
              f"{prob} {mode}: objective {obj}")
        check(n1 > 0, f"{prob} {mode}: K1 never launched")
        traj = np.asarray(ph.returnTraj())
        check(np.isfinite(traj).all(), f"{prob} {mode}: trajectory")


def phase_formation(ast, ck, nsegs):
    """Phase 8: formation flying with a PathToPath link; the border
    (b = segments + 5) is wider than 64, so it goes through the wide K1
    kernel.  Returns the wide kernel's launches."""
    rflag, rit, robj, rb = FORMATION[nsegs]
    ocp, pa, pb = build_formation(ast, nsegs)
    ocp.optimizer.set_PrintLevel(2)
    ocp.optimizer.UseFused = False      # held to the JAX host loop
    flag, n1, nw, secs = counted(ck, ocp.optimize)
    it, obj = ocp.optimizer.LastIterNum, ocp.optimizer.LastObjVal
    bs = ocp.optimizer.kkt.bs
    print(f"formation flying {nsegs} segs (K {bs.K} W {bs.W} b {bs.b}): "
          f"flag {flag} iters {it} obj {obj:.16f}, K1 launches {n1} "
          f"narrow / {nw} wide, {secs:.3f} s")
    check(flag == rflag and it == rit, "formation flying flag/iterations")
    check(abs(obj - robj) <= 1e-8 * robj, "formation flying objective")
    check(bs.b == rb, f"formation flying border {bs.b} != {rb}")
    check(nw > 0, "formation flying never launched the wide K1 kernel")
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    check(np.abs(gap - 0.2).max() < 1e-6, "formation offset not held")
    return nw


def run_delta3(ast, ck, nsegs):
    ocp, phases = build_delta3(ast, nsegs)
    ocp.optimizer.set_PrintLevel(1)
    ocp.optimizer.UseFused = False      # held to the JAX host loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ocp.transcribe()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    flag, n1, nw, t_solve = counted(ck, ocp.solve_optimize)
    opt = ocp.optimizer
    mass = phases[3].returnTraj()[-1][6] * D3["Mstar"]
    bs = opt.kkt.bs
    nodes = sum(p.numNodes for p in phases)
    print(f"Delta III {nsegs} segs/phase ({nodes} nodes, K {bs.K} W {bs.W} "
          f"b {bs.b}): flag {flag} iters {opt.LastIterNum} final mass "
          f"{mass:.12f} kg, K1 launches {n1} narrow / {nw} wide")
    rflag, rit, rmass = DELTA3[nsegs]
    check(flag == rflag, f"Delta III {nsegs}: flag {flag}")
    check(abs(opt.LastIterNum - rit) <= 1,
          f"Delta III {nsegs}: iterations {opt.LastIterNum}")
    check(n1 > 0, f"Delta III {nsegs}: K1 never launched")
    for p in phases:
        check(np.isfinite(np.asarray(p.returnTraj())).all(),
              f"Delta III {nsegs}: trajectory not finite")
    return ocp, mass, n1, t_setup, t_solve


def phase_delta3_40(ast, ck):
    """Phase 9: Delta III at 40 segments per phase, and a bitwise
    repeatability check of one factorization."""
    ocp, mass, _, _, _ = run_delta3(ast, ck, 40)
    rmass = DELTA3[40][2]
    check(abs(mass - rmass) <= 1e-7 * rmass, "Delta III 40: final mass")
    check_repeatable_factor(ocp.optimizer, ocp._make_input())


def phase_delta3_full(ast, ck):
    """Phase 10: Delta III at 2500 segments per phase (10,004 nodes)."""
    reset_peak_memory()
    ocp, mass, launches, t_setup, t_solve = run_delta3(ast, ck, 2500)
    opt = ocp.optimizer
    it = opt.LastIterNum
    peak = torch.cuda.max_memory_allocated()
    print(f"  transcription {t_setup:.3f} s, solve_optimize "
          f"(time-to-solution) {t_solve:.3f} s, {it / t_solve:.3f} "
          f"iterations/s, peak device memory {peak / 2**20:.1f} MiB, "
          f"K1 launches {launches}")
    print(f"  host-clock split of solve_optimize: function evaluation "
          f"{opt.LastFuncTime:.3f} s, KKT factor+solve {opt.LastKKTTime:.3f} s")
    rmass = DELTA3[2500][2]
    check(abs(mass - rmass) <= 1e-6 * rmass, "Delta III 2500: final mass")
    return launches, ocp.Phases


# the JAX package's CPU result (DOPRI87, default step 0.1, AbsTol 1e-12) for
# the first 4 rows of two_body_rows(4096), each over its own period
TWO_BODY_JAX = np.array([
    [8.5142808110691826e-01, 1.9683262318463770e-12, 8.8398449876160289e-13,
     -4.1582191589047079e-02, 8.7888174656081530e-01, 3.9471144794300128e-01,
     3.7169786330663501e+00],
    [9.9971114497499658e-01, -4.3221075958526306e-12,
     -1.3764257348266924e-12, 4.0496656580893839e-02, 9.9528846259146464e-01,
     3.1696734859561798e-01, 7.2634680456883096e+00],
    [1.0405993430501908e+00, 3.3684183021901267e-13, 1.6426816422977319e-12,
     -1.6194179729347688e-01, 2.0051679106905462e-01, 9.7804063162506161e-01,
     7.3715596992523862e+00],
    [8.1147560334745783e-01, -7.9334022412544955e-14, 2.4311399666574400e-13,
     6.6650112799040748e-02, -3.4934312380000310e-01, 1.0706006624774353e+00,
     4.8281185191634144e+00]])


def phase_integrator(ast):
    """Phase 11: the batched adaptive integrator on the card."""
    nrows, nstm, ncpu = 4096, 256, 16
    rows, periods = two_body_rows(nrows)
    integ = two_body_ode(ast).integrator("DOPRI87", 0.1)
    dev_rows, dev_tfs = integ._rows(rows[:8], periods[:8])
    out, _, _ = integ._advance(dev_rows, dev_tfs)
    check(dev_rows.is_cuda and out.is_cuda,
          "the integrator's tensors are not on the card")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xf = np.stack(integ.integrate_parallel(rows, periods))
    secs = time.perf_counter() - t0
    steps = integ.LastStepCount
    print(f"integrator: {nrows} two-body rows over one period each, "
          f"DOPRI87, AbsTol 1e-12: {secs:.3f} s, {nrows / secs:.1f} rows/s, "
          f"{steps} steps in the longest row")
    check(np.isfinite(xf).all(), "integrated rows are not finite")
    closure = np.abs(xf[:, :6] - rows[:, :6]).max()
    print(f"  orbits close to {closure:.3e} after one period")
    check(closure < 1e-9, "the orbits do not close after one period")
    ej = np.abs(xf[:4] - TWO_BODY_JAX).max()
    print(f"  first 4 rows against the JAX package's CPU run: {ej:.3e}")
    check(ej <= 1e-9, "integrated rows differ from the JAX package's")

    # the same ODE built on the CPU, for the port's own CPU run
    ast.config.use_device("cpu")
    try:
        cpu = two_body_ode(ast).integrator("DOPRI87", 0.1)
        xc = np.stack(cpu.integrate_parallel(rows[:ncpu], periods[:ncpu]))
        sc, Jc = cpu.integrate_stm(rows[0], periods[0])
    finally:
        ast.config.use_device("cuda")
    ec = np.abs(xf[:ncpu] - xc).max()
    print(f"  first {ncpu} rows against the port's CPU run: {ec:.3e}")
    check(ec <= 1e-9, "integrated rows differ between the card and the CPU")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stm = integ.integrate_stm_parallel(rows[:nstm], periods[:nstm])
    secs = time.perf_counter() - t0
    J = np.stack([j for _, j in stm])
    dets = np.linalg.det(J[:, :6, :6])
    eJ = np.abs(J[0] - Jc).max() / np.abs(Jc).max()
    print(f"  state-transition matrices of {nstm} rows: {secs:.3f} s, "
          f"{nstm / secs:.1f} rows/s; |det - 1| up to "
          f"{np.abs(dets - 1).max():.3e}; row 0 against the CPU run "
          f"{eJ:.3e} relative")
    check(np.isfinite(J).all() and J.shape == (nstm, 7, 7),
          "state-transition matrices are not finite")
    check(np.abs(dets - 1).max() < 1e-6,
          "state-transition matrices are not volume preserving")
    check(eJ <= 1e-8, "state-transition matrix differs between the card "
          "and the CPU")

    # events: from apoapsis, stop where r.v rises through zero (periapsis,
    # half a period later)
    nev = 32
    rng = np.random.default_rng(12)
    ra = 1.0 + 0.3 * rng.uniform(0, 1, nev)
    va = np.sqrt(1.0 / ra) * (0.7 + 0.2 * rng.uniform(0, 1, nev))
    ev_rows = np.zeros((nev, 7))
    ev_rows[:, 0], ev_rows[:, 4] = ra, va
    a = 1.0 / (2.0 / ra - va ** 2)
    half = np.pi * a ** 1.5
    A = ast.VectorFunctions.Arguments(7)
    rdotv = A.head3().dot(A.segment3(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = integ.integrate_dense_parallel(ev_rows, 3 * half, [(rdotv, 1, 1)],
                                         nsteps=2)
    secs = time.perf_counter() - t0
    tstop = np.array([traj[-1][6] for traj, _ in res])
    rstop = np.array([traj[-1][0] for traj, _ in res])
    et = np.abs(tstop - half).max()
    print(f"  periapsis-crossing stop events of {nev} rows: {secs:.3f} s, "
          f"stop times off by up to {et:.3e}")
    check(all(len(locs[0]) == 1 for _, locs in res),
          "an orbit did not stop at its first periapsis")
    check(et < 1e-8, "periapsis times are off")
    check(np.abs(rstop + (2 * a - ra)).max() < 1e-7,
          "periapsis positions are off")


@contextlib.contextmanager
def mesh_log():
    """Record (segments, combined error) at every mesh-error estimate of
    the adaptive loops run inside the block."""
    from asset_asrl_torch.OptimalControl import mesh
    seen = []
    plain = mesh.segment_errors

    def spy(phase):
        errs = plain(phase)
        seen.append((phase.numSegs,
                     mesh._combine(errs, phase.MeshErrorCriteria)))
        return errs
    mesh.segment_errors = spy
    try:
        yield seen
    finally:
        mesh.segment_errors = plain


def phase_hypersens(ast, ck):
    """Phase 12: the hypersensitive problem with the adaptive mesh.  The
    objective is held to 5e-5 relative: the last mesh is laid out by error
    estimates that are rounding noise over the flat middle of the
    trajectory, so its bounds, and with them the quadrature value it
    converges to, differ in the sixth digit between two machines (JAX on a
    CPU 1.673296, the port on a CPU 1.673286, on an H100 1.673283)."""
    rflag, rsegs, robj = HYPERSENS
    ph = build_hypersens(ast)
    ph.optimizer.set_PrintLevel(2)
    ph.optimizer.UseFused = False       # held to the JAX host loop
    reset_peak_memory()
    with mesh_log() as seen:
        flag, n1, nw, secs = counted(ck, ph.solve_optimize)
    obj = ph.optimizer.LastObjVal
    for i, (segs, err) in enumerate(seen):
        print(f"hypersensitive mesh iteration {i}: {segs} segments, error "
              f"{err:.3e}")
    print(f"hypersensitive adaptive: flag {flag}, {len(seen)} mesh "
          f"estimates, final segments {ph.numSegs}, obj {obj:.15f}, "
          f"{secs:.3f} s, K1 launches {n1} narrow / {nw} wide, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check(flag == rflag and ph.MeshConverged, "hypersensitive: flag")
    check([s for s, _ in seen] == rsegs,
          f"hypersensitive: segments per mesh iteration {seen}")
    check(abs(obj - robj) <= 5e-5 * robj, f"hypersensitive: objective {obj}")
    check(n1 > 0, "hypersensitive: K1 never launched")
    tab = ph.returnTrajTable()
    check(all(t.is_cuda for t in tab._tensors()),
          "the trajectory table's tensors are not on the card")
    return n1, nw


def phase_delta3_adaptive(ast, ck):
    """Phase 13: the adaptive-mesh Delta III at the width of the upstream
    regression."""
    rflag, rsegs, rmass = DELTA3_ADAPTIVE
    ocp, phases = build_delta3(ast, 40, adaptive=True)
    ocp.optimizer.set_PrintLevel(2)
    ocp.optimizer.UseFused = False      # held to the JAX host loop
    reset_peak_memory()
    with mesh_log() as seen:
        flag, n1, nw, secs = counted(ck, ocp.solve_optimize)
    mass = phases[3].returnTraj()[-1][6] * D3["Mstar"]
    segs = [p.numSegs for p in phases]
    print(f"Delta III adaptive: flag {flag}, {len(seen) // 4} mesh "
          f"iterations (errors {[f'{e:.3e}' for _, e in seen]}), segments "
          f"{segs}, final mass {mass:.12f} kg "
          f"({mass - DELTA3_PUBLISHED:+.6f} kg from the published optimum), "
          f"time-to-solution {secs:.3f} s, K1 launches {n1} narrow / {nw} "
          f"wide, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check(flag == rflag, f"Delta III adaptive: flag {flag}")
    check(segs == rsegs, f"Delta III adaptive: segments {segs}")
    check(all(p.MeshConverged for p in phases),
          "Delta III adaptive: mesh not converged")
    check(abs(mass - rmass) <= 1e-7 * rmass, "Delta III adaptive: final mass")
    check(abs(mass - DELTA3_PUBLISHED) < 0.01,
          "Delta III adaptive: not within 0.01 kg of the published optimum")
    check(n1 > 0, "Delta III adaptive: K1 never launched")
    return n1, nw


def phase_estimators(ast, ck, phases, obj_unscaled):
    """Phase 14: the three mesh-error estimators at 10,004 nodes, and the
    auto-scaled CartPole at 10,001 nodes."""
    from asset_asrl_torch.OptimalControl import mesh
    worst = {}
    for est in ("deboor", "residual", "integrator"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        errs = []
        for p in phases:
            p.MeshErrorEstimator = est
            errs.append(mesh.segment_errors(p))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        top = [float(e.max()) for e in errs]
        worst[est] = int(np.argmax(top))
        print(f"mesh estimator {est!r} on {sum(p.numNodes for p in phases)} "
              f"nodes ({[p.numSegs for p in phases]} segments): {secs:.3f} s,"
              f" largest error per phase {[f'{e:.3e}' for e in top]}")
        check(all(np.isfinite(e).all() and e.shape == (p.numSegs,)
                  for e, p in zip(errs, phases)),
              f"estimator {est}: errors not finite")
    check(len(set(worst.values())) == 1,
          f"the estimators disagree on the worst phase: {worst}")

    # Auto-scaling with unit 1 on every variable scales the rows only, so
    # the physical objective is the unscaled solve's.  The guess holds a
    # control of 1: with a control of 0 the integral objective has a zero
    # Jacobian at the guess and gets the largest scale there is, in the JAX
    # package too.  Both solves stop at a KKT error of 1e-6, which pins the
    # objective to about 1e-8: the check is 1e-7 relative.
    ph = build_cartpole(ast, 5000, u0=1.0)
    ph.setAutoScaling(True)
    ph.setUnits(np.ones(6))
    ph.optimizer.set_PrintLevel(2)
    ph.optimizer.UseFused = False       # against phase 6's host loop
    flag, n1, nw, secs = counted(ck, ph.optimize)
    obj = ph.optimizer.LastObjVal
    print(f"auto-scaled CartPole ({ph.numNodes} nodes, unit 1): flag {flag} "
          f"iters {ph.optimizer.LastIterNum} obj {obj:.15f} (unscaled "
          f"{obj_unscaled:.15f}, objective scale {ph._obj_scale:.6e}), "
          f"{secs:.3f} s, K1 launches {n1}")
    check(flag == 0, "auto-scaled CartPole did not converge")
    check(abs(obj - obj_unscaled) <= 1e-7 * obj_unscaled,
          "auto-scaled CartPole: objective differs from the unscaled one")
    check(n1 > 0, "auto-scaled CartPole never launched K1")
    return n1, nw


def fused_line(opt, secs):
    """Time-to-solution, rates and host reads of the last fused solve."""
    it = opt.LastIterNum
    st = opt.LastFusedStats
    return (f"{secs:.3f} s, {it / secs:.3f} iterations/s, "
            f"{st['factorizations'] / it:.3f} factorizations and "
            f"{st['syncs'] / it:.3f} host reads per iteration")


def phase_default_solve(ast, ck):
    """Phase 15: the default solve, the fused loop, against the JAX
    package's default solve.  Objectives to 1e-9 relative (1e-8 at
    10,001 nodes, where both stop at a KKT error of 1e-6), the init
    multipliers to 1e-9.  Returns the K1 launches (narrow, wide) of the
    two-phase formation flying and the 10,001-node solves."""
    for name, ph in (("Brachistochrone LGL3 24",
                      build_brachistochrone(ast, "LGL3", 24)),
                     ("CartPole LGL5 40", build_cartpole(ast, 40))):
        rflag, rit, robj = FUSED[name]
        opt = ph.optimizer
        opt.set_PrintLevel(2)
        check(opt.UseFused and opt.InitLmults, "the default is not fused")
        flag, n1, _, secs = counted(ck, ph.optimize)
        obj = opt.LastObjVal
        print(f"default solve, {name}: flag {flag} iters {opt.LastIterNum} "
              f"obj {obj:.16f} (JAX default {robj:.16f}), K1 launches {n1}, "
              f"{fused_line(opt, secs)}")
        check(flag == rflag and opt.LastIterNum == rit,
              f"default solve {name}: flag/iterations")
        check(abs(obj - robj) <= 1e-9 * robj, f"default solve {name}: obj")
        check(n1 > 0, f"default solve {name}: K1 never launched")

    ocp, pa, pb = build_formation(ast, 256)
    opt = ocp.optimizer
    opt.set_PrintLevel(2)
    check(opt.UseFused and opt.InitLmults, "the OCP default is not fused")
    flag, n1, nw, secs = counted(ck, ocp.optimize)
    rflag, rit, robj = FUSED["formation 256"]
    obj = opt.LastObjVal
    print(f"default solve, formation flying 256 segs (b {opt.kkt.bs.b}): "
          f"flag {flag} iters {opt.LastIterNum} obj {obj:.16f} (JAX default "
          f"{robj:.16f}), K1 launches {n1} narrow / {nw} wide, "
          f"{fused_line(opt, secs)}")
    check(flag == rflag and opt.LastIterNum == rit,
          "default solve, formation flying: flag/iterations")
    check(abs(obj - robj) <= 1e-9 * robj,
          "default solve, formation flying: objective")
    check(nw > 0, "default solve, formation flying: wide K1 never launched")
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    check(np.abs(gap - 0.2).max() < 1e-6, "formation offset not held")
    out = {"default (fused) solve, formation flying 256 segments": (n1, nw)}

    ph = build_cartpole(ast, 40, u0=1.0)
    ph.optimizer.set_PrintLevel(2)
    ph.transcribe()
    lamE = ph.optimizer.init(ph.makeSolverInput())[2]
    rnorm, rfirst, rarg = INIT_40
    norm = float(np.linalg.norm(lamE))
    print(f"PSIOPT.init, CartPole 40 segments, control guess 1: |lamE| "
          f"{norm:.16f} (JAX {rnorm:.16f}), lamE[:4] {lamE[:4].tolist()}, "
          f"largest at {int(np.abs(lamE).argmax())}")
    check(abs(norm - rnorm) <= 1e-9 * rnorm
          and np.abs(lamE[:4] - rfirst).max() <= 1e-9 * rnorm
          and int(np.abs(lamE).argmax()) == rarg, "PSIOPT.init off")

    ph = build_brachistochrone(ast, "LGL3", 24)
    opt = ph.optimizer
    opt.set_PrintLevel(2)
    opt.MaxIters, opt.ReturnBest = 4, True
    flag = ph.optimize()
    rflag, rit, robj = RETURN_BEST
    print(f"ReturnBest, Brachistochrone capped at 4 iterations: flag {flag} "
          f"iters {opt.LastIterNum} obj {opt.LastObjVal:.16f} (JAX "
          f"{robj:.16f})")
    check(flag == rflag and opt.LastIterNum == rit
          and abs(opt.LastObjVal - robj) <= 1e-9 * robj, "ReturnBest off")

    reset_peak_memory()
    ph = build_cartpole(ast, 5000)
    opt = ph.optimizer
    opt.set_PrintLevel(1)
    ph.transcribe()
    flag, n1, nw, secs = counted(ck, ph.optimize)
    peak = torch.cuda.max_memory_allocated()
    obj = opt.LastObjVal
    rflag, rit, robj = FUSED["CartPole LGL5 5000"]
    print(f"default solve, CartPole 5000 segs ({ph.numNodes} nodes): flag "
          f"{flag} iters {opt.LastIterNum} obj {obj:.15f} (JAX default "
          f"{robj:.15f}), K1 launches {n1}")
    print(f"  time-to-solution {fused_line(opt, secs)}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    dev = ast.config.DEVICE
    state = [ast.config.tensor(a, dev) for a in (
        ph.makeSolverInput(), opt.LastSlacks, opt.LastEqLmults,
        opt.LastIqLmults)]
    st = opt.measure_stage_times(*state, opt.initMu, opt.ObjScale)
    print("  stage times at the solution (LastStageTimes, ms): " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in st.items()))
    check(flag == rflag and opt.LastIterNum == rit,
          "default solve at 10,001 nodes: flag/iterations")
    check(abs(obj - robj) <= 1e-8 * robj,
          "default solve at 10,001 nodes: objective")
    check(n1 > 0, "default solve at 10,001 nodes: K1 never launched")
    out["default (fused) solve, CartPole 10,001 nodes"] = (n1, nw)
    return out


@contextlib.contextmanager
def k1_log(kb):
    """Record the (blocks, width) of every K1 launch the block KKT makes
    inside the block."""
    shapes = []
    plain = kb.gj_inverse_inertia

    def spy(D):
        shapes.append(tuple(D.shape[:2]))
        return plain(D)
    kb.gj_inverse_inertia = spy
    try:
        yield shapes
    finally:
        kb.gj_inverse_inertia = plain


def run_ensemble(ast, ck, kb, name, ph, perts, ref=None):
    """One solve_ensemble on the card; every K1 launch must cover every
    lane, and lane 0 and the lane with the most iterations, solved alone
    through optimize(), must equal their lanes (flag and iterations, the
    objective to 1e-9 relative).  Returns the K1 launches (narrow,
    wide)."""
    from asset_asrl_torch.parallel import solve_ensemble
    B = len(perts)
    base = ph.makeSolverInput()
    reset_peak_memory()
    with k1_log(kb) as shapes:
        res, n1, nw, secs = counted(ck, lambda: solve_ensemble(
            ph, perturb_states=perts))
    peak = torch.cuda.max_memory_allocated()
    st = ph.optimizer.LastFusedStats
    iters = res["iters"]
    print(f"{name} ensemble, {B} scenarios: flags "
          f"{np.bincount(res['flags'], minlength=4).tolist()}, iterations "
          f"{iters.min()}..{iters.max()} ({iters.sum()} lane-iterations), "
          f"{secs:.3f} s: {B / secs:.2f} scenarios/s, "
          f"{iters.sum() / secs:.2f} lane-iterations/s; {st['iterations']} "
          f"batched iterations, {st['factorizations']} factorizations, "
          f"{st['syncs']} host reads; peak device memory "
          f"{peak / 2**20:.1f} MiB; K1 launches {n1} narrow / {nw} wide")
    counts = {}
    for k in shapes:
        counts[k] = counts.get(k, 0) + 1
    print("  K1 launch shapes (blocks, width): count " + ", ".join(
        f"{k}: {v}" for k, v in sorted(counts.items(), reverse=True)))
    check(np.isfinite(res["x"]).all() and res["x"].shape == (B, base.size),
          f"{name} ensemble: x")
    check(n1 + nw == len(shapes) > 0
          and all(k % B == 0 for k, _ in shapes),
          f"{name} ensemble: a K1 launch does not cover every lane")
    if ref is not None:
        rflag, rit, robjs = ref
        dev = np.abs(res["objs"][:len(robjs)] - robjs).max()
        print(f"  against the JAX package's ensemble: objectives of lanes "
              f"0-{len(robjs) - 1} within {dev:.3e}")
        check((res["flags"] == rflag).all() and (iters == rit).all(),
              f"{name} ensemble: flags/iterations differ from JAX")
        check(dev <= 1e-9 * max(abs(r) for r in robjs),
              f"{name} ensemble: objectives differ from JAX")
    opt = ph.optimizer
    for i in sorted({0, int(np.argmax(iters))}):
        t0 = time.perf_counter()
        opt.optimize(base + perts[i])
        secs = time.perf_counter() - t0
        robj = float(res["objs"][i])
        print(f"  lane {i} alone: flag {opt.ConvergeFlag} iters "
              f"{opt.LastIterNum} obj {opt.LastObjVal:.16f} (in the batch: "
              f"flag {res['flags'][i]} iters {iters[i]} obj {robj:.16f}), "
              f"{secs:.3f} s")
        check(opt.ConvergeFlag == res["flags"][i]
              and opt.LastIterNum == iters[i],
              f"{name} ensemble: lane {i} differs from its solo solve")
        check(abs(opt.LastObjVal - robj) <= 1e-9 * abs(robj),
              f"{name} ensemble: lane {i} objective")
    return n1, nw


def phase_ensembles(ast, ck, kb):
    """Phase 16: the MultiSpacecraft leg at 512 scenarios (perturbations
    default_rng(7) x 1e-4 about the solved baseline, as the example) and
    the 10,001-node CartPole at 16 scenarios (default_rng(3) x 1e-3 on the
    initial guess, as `tests/test_parallel.py`).  Returns the K1 launches
    (narrow, wide) of each."""
    ph = build_multispacecraft(ast)
    ph.optimizer.set_PrintLevel(2)
    flag = ph.optimize()
    rflag, rit, robj = MSC_BASE
    print(f"MultiSpacecraft baseline (LGL3, 12 segments, n "
          f"{ph._nlp.numPrimal}): flag {flag} iters "
          f"{ph.optimizer.LastIterNum} obj {ph.optimizer.LastObjVal:.16f} "
          f"(JAX default {robj:.16f})")
    check(flag == rflag and ph.optimizer.LastIterNum == rit
          and abs(ph.optimizer.LastObjVal - robj) <= 1e-9 * robj,
          "MultiSpacecraft baseline")
    base = ph.makeSolverInput()
    rng = np.random.default_rng(7)
    perts = [rng.normal(size=base.shape) * 1e-4 for _ in range(512)]
    out = {"MultiSpacecraft ensemble, 512 scenarios": run_ensemble(
        ast, ck, kb, "MultiSpacecraft", ph, perts, MSC_512)}

    ph = build_cartpole(ast, 5000)
    ph.optimizer.set_PrintLevel(2)
    ph.transcribe()
    base = ph.makeSolverInput()
    rng = np.random.default_rng(3)
    perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(16)]
    out["CartPole ensemble, 10,001 nodes, 16 scenarios"] = run_ensemble(
        ast, ck, kb, "CartPole 10,001 nodes", ph, perts)
    return out


@contextlib.contextmanager
def on_cpu(ast):
    """Build and run on the CPU inside the block (the port's own CPU run,
    which a card result is held to)."""
    dev = ast.config.DEVICE
    ast.config.use_device("cpu")
    try:
        yield
    finally:
        ast.config.use_device(dev)


def family_all(f, x, lam):
    """Values, Jacobians and forward-over-reverse adjoint Hessians of f
    over the rows of x (multipliers lam), one vmapped pass."""
    from torch.func import jacfwd, vjp, vmap

    def all3(y, l):
        ag = lambda z: vjp(f.trace, z)[1](l)[0]  # noqa: E731
        return f.trace(y), jacfwd(f.trace)(y), jacfwd(ag)(y)
    return vmap(all3)(x, lam)


def worst(a, b):
    """Largest deviation of b from a, relative to a's largest entry (1 at
    least): tensors on any device or numpy."""
    a = [np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in a]
    b = [np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in b]
    return max(float(np.abs(u - v).max() / max(1.0, np.abs(u).max()))
               for u, v in zip(a, b))


def report(name, secs, peak, n1, nw):
    print(f"  [{name}] {secs:.3f} s, peak device memory "
          f"{peak / 2**20:.1f} MiB, K1 launches {n1} narrow / {nw} wide")


def phase_vf_tail(ast, ck):
    """Phase 17: the VectorFunctions tail on the card.  The table-driven
    climb (cubic 1-D and 2-D `vf.InterpTable`s in the dynamics) at the
    example's 50 segments under the default solve, against the JAX CPU
    default solve (flag, iterations, objective to 1e-9); the Kepler
    root-finder node in a family of 65,536 rows (values, Jacobians,
    adjoint Hessians) against the port's CPU run on 256 rows (1e-12) and
    the JAX package's numbers on 4 (1e-10); a `PyVectorFunction` inside
    an expression, whose Jacobian on the card equals the CPU's (1e-12).
    Returns the K1 launches of the climb."""
    vf = ast.VectorFunctions
    reset_peak_memory()
    ph = build_climb(ast, 50)
    opt = ph.optimizer
    opt.set_PrintLevel(2)
    flag, n1, nw, secs = counted(ck, ph.optimize)
    rflag, rit, robj = CLIMB_50
    obj = opt.LastObjVal
    tclimb = ph.returnTraj()[-1][4] * 250.0
    print(f"climb with tables, 50 segments: flag {flag} iters "
          f"{opt.LastIterNum} obj {obj:.16f} (JAX default {robj:.16f}), "
          f"climb time {tclimb:.3f} s, {fused_line(opt, secs)}")
    report("climb", secs, torch.cuda.max_memory_allocated(), n1, nw)
    check(flag == rflag and opt.LastIterNum == rit, "climb: flag/iterations")
    check(abs(obj - robj) <= 1e-9 * abs(robj), "climb: objective")
    check(n1 > 0, "climb: K1 never launched")
    out = {"phase 17, climb with tables, 50 segments": (n1, nw)}

    reset_peak_memory()
    x, lam = kepler_rows(65536)
    f = kepler_family(ast)
    X, L = ast.config.tensor(x), ast.config.tensor(lam)
    family_all(f, X[:8], L[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = family_all(f, X, L)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with on_cpu(ast):
        fc = kepler_family(ast)
        cpu = family_all(fc, ast.config.tensor(x[:256]),
                         ast.config.tensor(lam[:256]))
    d_cpu = worst(cpu, [g[:256] for g in got])
    ref = [np.reshape(r, (4, -1)) for r in KEPLER_FAMILY_4]
    d_jax = worst(ref, [g[:4].reshape(4, -1) for g in got])
    print(f"Kepler root-finder family, 65,536 rows: values, Jacobians and "
          f"adjoint Hessians in {secs:.3f} s ({65536 / secs:.0f} rows/s); "
          f"against the CPU on 256 rows {d_cpu:.2e}, against JAX on 4 "
          f"rows {d_jax:.2e}")
    report("root-finder family", secs, torch.cuda.max_memory_allocated(),
           0, 0)
    check(all(torch.isfinite(g).all() for g in got),
          "root-finder family: not finite")
    check(d_cpu <= 1e-12, "root-finder family: card differs from the CPU")
    check(d_jax <= 1e-10, "root-finder family: card differs from JAX")

    calls = [0]

    def host(z):
        calls[0] += 1
        return np.array([z[0] * np.sin(z[1]) + z[2] ** 2,
                         np.exp(0.3 * z[0]) * z[1] - z[2]])

    def expr():
        pf = vf.PyVectorFunction(3, 2, host)
        a = vf.Arguments(4)
        return vf.stack([pf.eval(vf.stack([a[0] * a[3], vf.cos(a[1]),
                                           a[2] + a[3]])) * a[3],
                         vf.sin(a[0])])
    e = expr()
    pt = np.array([0.3, 0.2, -0.4, 1.2])
    with on_cpu(ast):
        jc = expr().jacobian(pt)
    jg = e.jacobian(pt)
    e.compute(pt)
    reps = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        e.compute(pt)
    t_val = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        e.jacobian(pt)
    t_jac = (time.perf_counter() - t0) / reps
    d = float(np.abs(jg - jc).max() / max(1.0, np.abs(jc).max()))
    print(f"PyVectorFunction in an expression: Jacobian on the card against "
          f"the CPU {d:.2e}; {1e3 * t_val:.3f} ms a value, {1e3 * t_jac:.3f} "
          f"ms a Jacobian (host callback and copies included)")
    check(d <= 1e-12, "PyVectorFunction: card Jacobian differs from the CPU")
    return out


def phase_astro(ast, ck):
    """Phase 18: Astro on the card.  An Earth to Mars porkchop grid of
    512 x 512 single-revolution Lambert solves in one batched call,
    against the JAX package on 64 seeded lanes (1e-10) and the port's CPU
    run on 4096 (1e-12), every lane a two-body arc by Kepler's equation
    and the conserved quantities (`conic_residuals`, 1e-10), and every
    lane propagated by `propagate_kepler` (16 chained steps) onto its
    arrival state (1e-8; a lane whose transfer passes within 0.1 AU of
    the Sun, where the universal-variable Newton of the propagator does
    not always converge, in the JAX package too, is held to the CPU run
    and to `conic_residuals` instead);
    the Dionysus transfer at 150 segments against the JAX CPU default
    solve (flag, iterations, final mass to 1e-9) and at 1000 segments
    (flag 0, mass above 2700 kg); the EPPR frame (`TwoBodyAnalytic`, N =
    800) and the NBody equations of motion over 4096 rows against the CPU
    (1e-9).  Returns the K1 launches of the solves."""
    from asset_asrl_torch.Astro import kepler as kp
    A = ast.Astro
    out = {}
    r1, r2, tof = porkchop()
    n = tof.shape[0]
    reset_peak_memory()
    R1, R2, TOF = (ast.config.tensor(a) for a in (r1, r2, tof))
    with torch.no_grad():
        kp._lambert_core(R1[:64], R2[:64], TOF[:64], 1.0, False, 0, False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        V1, V2 = kp._lambert_core(R1, R2, TOF, 1.0, False, 0, False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    v1, v2 = A.lambert_izzo_batch(r1, r2, tof)
    host_secs = time.perf_counter() - t0
    print(f"porkchop grid, Earth to Mars, {n} Lambert solves: {secs:.4f} s "
          f"on the card ({n / secs:.0f} solves/s; the host call with its "
          f"copies {host_secs:.4f} s); peak device memory "
          f"{peak / 2**20:.1f} MiB")
    report("porkchop Lambert", secs, peak, 0, 0)
    check(np.isfinite(v1).all() and np.isfinite(v2).all(),
          "porkchop: not finite")
    k = porkchop_lanes()
    d_jax = worst([np.reshape(PORKCHOP_64[0], (64, 3)),
                   np.reshape(PORKCHOP_64[1], (64, 3))], [v1[k], v2[k]])
    sub = np.random.default_rng(32).choice(n, min(n, 4096), replace=False)
    with on_cpu(ast):
        c1, c2 = A.lambert_izzo_batch(r1[sub], r2[sub], tof[sub])
    d_cpu = worst([c1, c2], [v1[sub], v2[sub]])
    x = np.concatenate([r1, v1], axis=1)
    t0 = time.perf_counter()
    for _ in range(16):
        x = A.propagate_kepler(x, tof / 16)
    t_prop = time.perf_counter() - t0
    miss = ~((np.abs(x[:, :3] - r2).max(1) <= 1e-8)
             & (np.abs(x[:, 3:] - v2).max(1) <= 1e-8))
    h = np.cross(r1, v1)
    a = -0.5 / (0.5 * (v1 * v1).sum(1) - 1.0 / np.linalg.norm(r1, axis=1))
    rp = a * (1 - np.sqrt(np.maximum(0.0, 1 - (h * h).sum(1) / a)))
    grazing = rp < 0.1
    with on_cpu(ast):
        g1, g2 = A.lambert_izzo_batch(r1[miss], r2[miss], tof[miss])
    d_miss = worst([g1, g2], [v1[miss], v2[miss]]) if miss.any() else 0.0
    conic = conic_residuals(r1, v1, r2, v2, tof)
    print(f"  against JAX on 64 seeded lanes {d_jax:.2e}; against the CPU "
          f"on 4096 lanes {d_cpu:.2e}; two-body arcs by Kepler's equation: "
          f"largest residual {conic.max():.2e} (the lanes that do not land "
          f"{conic[miss].max() if miss.any() else 0.0:.2e}); propagated in "
          f"16 steps ({t_prop:.3f} s): {n - miss.sum()} lanes land on their "
          f"arrival state (1e-8), {miss.sum()} do not, all of them passing "
          f"within 0.1 AU of the Sun ({grazing.sum()} lanes do), those "
          f"against the CPU {d_miss:.2e}")
    check(d_jax <= 1e-10, "porkchop: card differs from JAX")
    check(d_cpu <= 1e-12, "porkchop: card differs from the CPU")
    check(conic.max() <= 1e-10, "porkchop: a lane is not a two-body arc")
    check(not (miss & ~grazing).any() and miss.sum() <= n // 1000,
          "porkchop: a lane does not land on its arrival state")
    check(d_miss <= 1e-12, "porkchop: a sun-grazing lane differs from the CPU")

    reset_peak_memory()
    ph = build_dionysus(ast, 150)
    opt = ph.optimizer
    opt.set_PrintLevel(2)
    ph.transcribe()
    flag, n1, nw, secs = counted(ck, ph.optimize)
    mass = ph.returnTraj()[-1][6] * DIONYSUS_MASS
    rflag, rit, rmass = DIONYSUS_150
    print(f"Dionysus, 150 segments: flag {flag} iters {opt.LastIterNum} "
          f"final mass {mass:.10f} kg (JAX default {rflag}, {rit}, "
          f"{rmass:.10f} kg); time-to-solution {fused_line(opt, secs)}")
    report("Dionysus 150", secs, torch.cuda.max_memory_allocated(), n1, nw)
    check(flag == rflag and opt.LastIterNum == rit,
          "Dionysus 150: flag/iterations")
    check(abs(mass - rmass) <= 1e-9 * rmass, "Dionysus 150: final mass")
    check(n1 > 0, "Dionysus 150: K1 never launched")
    out["phase 18, Dionysus, 150 segments"] = (n1, nw)

    reset_peak_memory()
    ph = build_dionysus(ast, 1000)
    opt = ph.optimizer
    opt.set_PrintLevel(2)
    t0 = time.perf_counter()
    ph.transcribe()
    torch.cuda.synchronize()
    t_tr = time.perf_counter() - t0
    from asset_asrl_torch.Solvers import kkt_block as kb
    with k1_log(kb) as shapes:
        flag, n1, nw, secs = counted(ck, ph.optimize)
    traj = np.asarray(ph.returnTraj())
    mass = traj[-1][6] * DIONYSUS_MASS
    bs = opt.kkt.bs
    print(f"Dionysus, 1000 segments ({ph.numNodes} nodes; K {bs.K} W {bs.W} "
          f"b {bs.b}): flag {flag} iters {opt.LastIterNum} final mass "
          f"{mass:.10f} kg; transcription {t_tr:.3f} s, time-to-solution "
          f"{fused_line(opt, secs)}")
    counts = {}
    for k in shapes:
        counts[k] = counts.get(k, 0) + 1
    print("  K1 launch shapes (blocks, width): count " + ", ".join(
        f"{k}: {v}" for k, v in sorted(counts.items(), reverse=True)))
    report("Dionysus 1000", secs, torch.cuda.max_memory_allocated(), n1, nw)
    check(traj.shape == (2001, 11) and np.isfinite(traj).all(),
          "Dionysus 1000: trajectory")
    check(flag == 0 and mass > 2700, "Dionysus 1000: flag/final mass")
    out["phase 18, Dionysus, 1000 segments"] = (n1, nw)

    from asset_asrl_torch.Astro import Extensions as E
    c = A.Constants
    JD0, JDF = 2459000.5, 2459060.5

    def frames():
        eppr = E.EPPRFrame.TwoBodyAnalytic("EARTH", c.MuEarth, "MOON",
                                           c.MuMoon, c.LD, JD0, JDF,
                                           ecc=0.0549, N=800)
        a = ast.VectorFunctions.Arguments(7)
        f1 = eppr.EPPREOMs(a.head3(), a.segment3(3), a[6])
        tstar = np.sqrt(c.AU ** 3 / c.MuSun)
        tf = (JDF - JD0) * 24 * 3600 / tstar
        sun = [np.array([0, 0, 0, 0, 0, 0, t])
               for t in np.linspace(0, tf, 401)]
        nb = E.NBodyFrame("SUN", c.MuSun, c.AU, JD0, JDF, P1Data=sun)
        nb.AddBodyTable("JUPITER", E.KeplerianEphemeris(
            1.0, [5.2, 0.048, 0.02, 0, 0, 0.5], 0, tf, 400), c.MuJupiter)
        f2 = nb.NBodyEOMs(a.head3(), a.segment3(3), a[6])
        return f1, f2, tf

    reset_peak_memory()
    t0 = time.perf_counter()
    f1, f2, tf = frames()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(41)
    rows = np.concatenate([rng.normal(size=(4096, 3)) * 0.3 + [0.6, 0, 0],
                           rng.normal(size=(4096, 3)) * 0.2,
                           rng.uniform(0.0, 1.0, (4096, 1))], axis=1)
    rows_eppr, rows_nb = rows.copy(), rows.copy()
    rows_eppr[:, 6] *= 13.0
    rows_nb[:, 6] *= tf
    lam = rng.normal(size=(4096, 6))
    res = []
    for f, r in ((f1, rows_eppr), (f2, rows_nb)):
        X, L = ast.config.tensor(r), ast.config.tensor(lam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = family_all(f, X, L)
        torch.cuda.synchronize()
        res.append((got, time.perf_counter() - t0))
    with on_cpu(ast):
        g1, g2, _ = frames()
        cpu = [family_all(g, ast.config.tensor(r), ast.config.tensor(lam))
               for g, r in ((g1, rows_eppr), (g2, rows_nb))]
    d = [worst(cc, gg) for cc, (gg, _) in zip(cpu, res)]
    print(f"EPPR frame (N = 800) and NBody frame built in {t_build:.3f} s on "
          f"the card; EOM families over 4096 rows (values, Jacobians, "
          f"adjoint Hessians): EPPR {res[0][1]:.3f} s, NBody {res[1][1]:.3f} "
          f"s; against the CPU {d[0]:.2e}, {d[1]:.2e}")
    report("frames", t_build + res[0][1] + res[1][1],
           torch.cuda.max_memory_allocated(), 0, 0)
    check(max(d) <= 1e-9, "frames: card differs from the CPU")
    return out


def phase_solvers_tail(ast, ck):
    """Phase 19: what only the CPU had run of the Solvers tail, each
    against its CPU result: Rosenbrock through `OptimizationProblem` (the
    dense KKT, host loop) under NOLS, AUGLANG and L1; a Brachistochrone
    phase with `setKKTBackend("dense")` (host loop); `Jet.map` over three
    phases (the default solve).  Flags and iterations equal, results to
    1e-9.  Returns the K1 launches of the Jet phases."""
    vf = ast.VectorFunctions

    def rosenbrock(mode):
        xy = vf.Arguments(2)
        prob = ast.Solvers.OptimizationProblem()
        prob.setVars([-1, -1])
        prob.addObjective((1 - xy[0]) ** 2 + 100 * (xy[1] - xy[0] ** 2) ** 2,
                          [0, 1])
        prob.addInequalCon(vf.Arguments(2).squared_norm() - 2.0, [0, 1])
        prob.optimizer.set_OptLSMode(mode)
        prob.optimizer.PrintLevel = 3
        return prob

    def dense():
        p = build_brachistochrone(ast, "LGL3", 16)
        p.optimizer.set_PrintLevel(2)
        p.optimizer.UseFused = False
        p.setKKTBackend("dense")
        return p

    def jet():
        def gen(n):
            p = build_brachistochrone(ast, "LGL5", n)
            p.optimizer.set_PrintLevel(2)
            return p
        return ast.Solvers.Jet.map(gen, [12, 16, 20], nthreads=3)

    def summary(p):
        o = p.optimizer
        x = p.returnVars() if hasattr(p, "returnVars") \
            else np.asarray(p.returnTraj())
        return o.ConvergeFlag, o.LastIterNum, o.LastObjVal, x

    def solve(probs):
        for p in probs:
            p.optimize()
        return probs

    runs = [("OptimizationProblem " + m, lambda m=m: solve([rosenbrock(m)]))
            for m in ("NOLS", "AUGLANG", "L1")]
    runs += [("dense KKT phase", lambda: solve([dense()])), ("Jet.map", jet)]
    out = {}
    for name, run in runs:
        reset_peak_memory()
        probs, n1, nw, secs = counted(ck, run)
        got = [summary(p) for p in probs]
        with on_cpu(ast):
            cpu = [summary(p) for p in run()]
        ok = len(got) == len(cpu) and all(
            g[0] == c[0] == 0 and g[1] == c[1]
            and abs(g[2] - c[2]) <= 1e-9 * max(1.0, abs(c[2]))
            and worst([c[3]], [g[3]]) <= 1e-9 for g, c in zip(got, cpu))
        print(f"{name}: flags {[g[0] for g in got]} iters "
              f"{[g[1] for g in got]} objs {[f'{g[2]:.14f}' for g in got]} "
              f"(CPU iters {[c[1] for c in cpu]})")
        report(name, secs, torch.cuda.max_memory_allocated(), n1, nw)
        check(ok, f"{name}: the card differs from the CPU")
        out["phase 19, " + name] = (n1, nw)
    return out


def free_port():
    """A free TCP port on 127.0.0.1 for the process group's rendezvous."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def block_matvec(blocks, y, z):
    """[T, B; B^T, C] [y; z] of one problem's blocks (diag, lower, B, C):
    y (K, W), z (b,)."""
    diag, lower, B, C = blocks
    Ay = (diag @ y[..., None])[..., 0] + (B @ z)
    Ay[1:] += (lower[:-1] @ y[:-1, :, None])[..., 0]
    Ay[:-1] += (lower[:-1].transpose(-1, -2) @ y[1:, :, None])[..., 0]
    return Ay, (B.transpose(-1, -2) @ y[..., None])[..., 0].sum(0) + C @ z


def shape_counts(shapes):
    counts = {}
    for k in shapes:
        counts[k] = counts.get(k, 0) + 1
    return sorted(counts.items(), key=lambda kv: (-kv[0][0], kv[0][1]))


def phase_distribution(ast, ck, kb, nsegs=5000, formation=256, ens_segs=128,
                       lanes=16):
    """Phase 20: distribution.  A one-rank process group (NCCL on the
    card); the 10,001-node CartPole's default solve on the block backend,
    then sharded flat over `chain_mesh(shards=8)` and hierarchically over
    a (2, 4) ("host", "chip") mesh on the one rank, then the three again
    (host-bound times spread between runs).  Each sharded solve is held to
    the first block solve: flag 0 and equal, objective to 1e-9 relative,
    iterations equal or within 1.  At the block solve's converged blocks
    (`storespmat`) one factor + solve through each backend: neigs equal,
    each sharded residual at most 10x the block backend's own.  Formation
    flying at 256 segments a phase through `ocp.setKKTBackend("sharded")`
    (D = 8; the reduced border (1, 261, 261) takes the wide K1) against
    the block backend: flag and objective to 1e-8.  A 16-lane CartPole
    ensemble at 128 segments over a ("scenario",) mesh of 8 shards against
    no mesh: flags and iterations equal, x to 1e-12.  `Utils.Profiler`
    around one sharded factor: its trace names K1's narrow kernel.
    Returns (K1 launches of each run, the K1 shapes of the flat sharded
    CartPole solve)."""
    import tempfile
    from asset_asrl_torch import distributed as dst
    from asset_asrl_torch.parallel import solve_ensemble
    dist = torch.distributed
    cuda = ast.config.DEVICE.type == "cuda"
    dst.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    backend = dist.get_backend()
    print(f"process group: backend {backend}, world {dist.get_world_size()}"
          f", rank {dist.get_rank()}")
    check(backend == ("nccl" if cuda else "gloo"),
          f"process group backend {backend}")
    out = {}

    def solve(name, build, mesh):
        """One default solve, K1 shapes and collectives recorded."""
        reset_peak_memory()
        held = torch.cuda.memory_allocated() if cuda else 0
        prob = build()
        opt = prob.optimizer
        opt.set_PrintLevel(2)
        opt.storespmat = True
        if mesh is not None:
            prob.setKKTBackend("sharded", mesh=mesh)
        prob.transcribe()
        calls = dict(mesh.calls) if mesh is not None else None
        with k1_log(kb) as shapes:
            flag, n1, nw, secs = counted(ck, prob.optimize)
        peak = torch.cuda.max_memory_allocated() - held if cuda else 0
        it = opt.LastIterNum
        coll = "" if mesh is None else ", collectives " + ", ".join(
            f"{k} {mesh.calls[k] - calls[k]}" for k in calls)
        print(f"{name}: flag {flag} iters {it} obj {opt.LastObjVal:.16f}, "
              f"{secs:.3f} s, {it / secs:.3f} iterations/s, peak device "
              f"memory {peak / 2**20:.1f} MiB above the problems held, "
              f"K1 launches {n1} narrow / {nw} wide{coll}")
        print("  K1 launch shapes (blocks, width): count " + ", ".join(
            f"{k}: {v}" for k, v in shape_counts(shapes)))
        if mesh is not None:
            check(min(mesh.calls[k] - calls[k] for k in calls) > 0,
                  f"{name}: no collective went through the group")
        out["phase 20, " + name] = (n1, nw)
        return prob, flag, it, opt.LastObjVal, secs, shapes

    flat, hier = dst.chain_mesh(shards=8), dst.Mesh((2, 4), ("host", "chip"))
    meshes = [("block", None), ("flat D=8", flat),
              ("hierarchical (2, 4)", hier), ("block again", None),
              ("flat D=8 again", flat), ("hierarchical (2, 4) again", hier)]
    runs = {}
    for label, mesh in meshes:
        runs[label] = solve(
            f"CartPole {nsegs} segs, {label}",
            lambda: build_cartpole(ast, nsegs), mesh)
        ph = runs[label][0]
        opt = ph.optimizer
        kkt = opt.kkt
        check(isinstance(kkt, kb.BlockKKT) == (mesh is None),
              f"{label}: backend {type(kkt).__name__}")
        if mesh is not None:
            check(kkt.hier == label.startswith("hier") and kkt.D == 8,
                  f"{label}: sharding {kkt.hier} {kkt.D}")
        state = [ast.config.tensor(a) for a in (
            ph.makeSolverInput(), opt.LastSlacks, opt.LastEqLmults,
            opt.LastIqLmults)]
        st = opt.measure_stage_times(*state, opt.initMu, opt.ObjScale)
        print("  stage times at the solution (ms): " + ", ".join(
            f"{k} {1e3 * v:.3f}" for k, v in st.items()))
    _, bflag, bit, bobj, _, _ = runs["block"]
    best = min(runs["block"][4], runs["block again"][4])
    for label in ("flat D=8", "hierarchical (2, 4)"):
        for again in ("", " again"):
            _, flag, it, obj, secs, _ = runs[label + again]
            print(f"  {label + again} against the block solve: objective "
                  f"rel {abs(obj - bobj) / abs(bobj):.3e}, iterations {it} "
                  f"vs {bit}, time {secs / best:.3f}x the faster block "
                  f"solve")
            check(flag == bflag == 0 and abs(it - bit) <= 1
                  and abs(obj - bobj) <= 1e-9 * abs(bobj),
                  f"sharded CartPole {label} differs from the block solve")

    # one factor + solve of the block solve's converged blocks each
    opt = runs["block"][0].optimizer
    blocks = [ast.config.tensor(a)[None] for a in opt.LastKKTBlocks]
    rng = np.random.default_rng(20)
    K, W = blocks[0].shape[1:3]
    b = blocks[3].shape[-1]
    r = ast.config.tensor(rng.normal(size=(1, K, W)))
    rb = ast.config.tensor(rng.normal(size=(1, b)))
    kkt_checks = {}
    for label in ("block", "flat D=8", "hierarchical (2, 4)"):
        kkt = runs[label][0].optimizer.kkt
        fac, neigs = kkt._factor_blocks_impl(blocks, opt.deltaH, opt.gammaE)
        y, z = kkt._block_solve(fac, r, rb)
        reg = kkt._base._regularize(blocks, opt.deltaH, opt.gammaE) \
            if label != "block" else kkt._regularize(blocks, opt.deltaH,
                                                     opt.gammaE)
        Ay, Az = block_matvec([t[0] for t in reg], y[0], z[0])
        res = float(torch.cat([(Ay - r[0]).reshape(-1), Az - rb[0]]).norm()
                    / torch.cat([r[0].reshape(-1), rb[0]]).norm())
        kkt_checks[label] = (int(neigs[0]), res)
        print(f"  converged blocks, {label}: neigs {int(neigs[0])}, "
              f"residual |Ax - r|/|r| {res:.3e}")
    nb, rblock = kkt_checks["block"]
    check(all(n == nb and res <= 10 * max(rblock, 1e-16)
              for n, res in kkt_checks.values()),
          "sharded factor at the converged blocks: neigs or residual off")

    # Utils.Profiler around one sharded factor
    kkt = runs["flat D=8"][0].optimizer.kkt
    with tempfile.TemporaryDirectory() as tmp:
        with ast.Utils.Profiler(tmp) as prof:
            kkt._factor_blocks_impl(blocks, opt.deltaH, opt.gammaE)
        with open(prof.trace_path) as f:
            trace = f.read()
    names = sorted(set(re.findall(r"gj_(?:warp|pair)_kernel", trace)))
    print(f"  Utils.Profiler around one sharded factor: {prof.elapsed:.4f} "
          f"s, a {len(trace)}-byte trace naming {names}")
    check(not cuda or names, "the profiler trace does not name K1")
    flat_shapes = runs["flat D=8"][5]
    del runs, blocks, kkt, prof

    # formation flying, the wide reduced border
    res = {}
    for label, mesh in (("block", None),
                        ("sharded D=8", dst.chain_mesh(shards=8))):
        prob, flag, it, obj, secs, _ = solve(
            f"formation flying {formation} segs, {label}",
            lambda: build_formation(ast, formation)[0], mesh)
        res[label] = (flag, obj, prob.optimizer.kkt.bs.b)
    (f1, o1, b1), (f2, o2, _) = res["block"], res["sharded D=8"]
    print(f"  sharded against block: objective rel "
          f"{abs(o2 - o1) / abs(o1):.3e} (border b {b1})")
    check(f1 == f2 == 0 and abs(o2 - o1) <= 1e-8 * abs(o1),
          "sharded formation flying differs from the block solve")

    # the ensemble over a scenario mesh
    ph = build_cartpole(ast, ens_segs)
    ph.optimizer.set_PrintLevel(2)
    ph.transcribe()
    base = ph.makeSolverInput()
    rng = np.random.default_rng(3)
    perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(lanes)]
    ens = {}
    mesh = dst.chain_mesh(axis="scenario", shards=8)
    for label, m in (("no mesh", None), ("scenario mesh of 8", mesh)):
        calls = dict(mesh.calls)
        e, n1, nw, secs = counted(
            ck, lambda: solve_ensemble(ph, perturb_states=perts, mesh=m))
        ens[label] = e
        print(f"CartPole {ens_segs} segs ensemble, {lanes} lanes, {label}: "
              f"flags {np.bincount(e['flags'], minlength=4).tolist()}, "
              f"iterations {e['iters'].min()}..{e['iters'].max()}, "
              f"{secs:.3f} s, K1 launches {n1}, all_gather calls "
              f"{mesh.calls['all_gather'] - calls['all_gather']}")
        out[f"phase 20, CartPole ensemble {lanes} lanes, {label}"] = (n1, nw)
    e0, e1 = ens["no mesh"], ens["scenario mesh of 8"]
    dev = float(np.abs(e0["x"] - e1["x"]).max())
    print(f"  meshed against unmeshed: x within {dev:.3e}")
    check(np.array_equal(e0["flags"], e1["flags"])
          and np.array_equal(e0["iters"], e1["iters"]) and dev <= 1e-12
          and mesh.calls["all_gather"] > 0,
          "the ensemble over a mesh differs from the unmeshed one")
    dist.destroy_process_group()
    return out, flat_shapes


def time_sharded_k1(ck, shapes):
    """K1 against its plain version (1e-12) and timed at the sharded
    CartPole's launch shapes: the three largest (the first local levels
    of the 8 shards in one launch) and the reduced chain's first level
    (4 blocks for 8 shards)."""
    distinct = sorted(set(shapes), reverse=True)
    pick = distinct[:3] + [k for k in distinct if k[0] == 4]
    for i, (K, W) in enumerate(dict.fromkeys(pick)):
        D = quasi_definite_blocks(K, W, seed=300 + i, dtype=torch.float64)
        X = ck.gj_inverse_inertia(D)[0]
        Xr = plain_inertia(ck, D)[0]
        print(f"sharded-path K1 ({K},{W},{W}) f64: inverse rel "
              f"{rel(X, Xr):.3e}")
        check(rel(X, Xr) <= 1e-12, f"K1 off at the sharded shape {K, W}")
        k1_time(ck, D, float((X - Xr).abs().max()))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    import asset_asrl_torch as ast
    from asset_asrl_torch.Solvers import cuda_kernels as ck
    from asset_asrl_torch.Solvers import kkt_block as kb
    check(ast.config.DEVICE.type == "cuda", "port did not pick the card")

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    ck.build()
    print(f"build: K1 compiled and loaded in {time.perf_counter() - t0:.2f} s")
    print_ptxas(ck)

    k1 = phase_kernel(ck)
    phase_bcr(kb)
    phase_slice40(ast, ck)
    obj_5000 = phase_slice5000(ast, ck)
    phase_breadth(ast, ck)
    wide = {n: phase_formation(ast, ck, n) for n in (80, 256, 512)}[256]
    phase_delta3_40(ast, ck)
    narrow, d3_phases = phase_delta3_full(ast, ck)
    phase_integrator(ast)
    adaptive = {"hypersensitive, adaptive mesh": phase_hypersens(ast, ck),
                "Delta III, adaptive mesh": phase_delta3_adaptive(ast, ck)}
    adaptive["auto-scaled CartPole, 10,001 nodes"] = phase_estimators(
        ast, ck, d3_phases, obj_5000)
    del d3_phases
    adaptive.update(phase_default_solve(ast, ck))
    adaptive.update(phase_ensembles(ast, ck, kb))
    for new_phase in (phase_vf_tail, phase_astro, phase_solvers_tail):
        t0 = time.perf_counter()
        adaptive.update(new_phase(ast, ck))
        print(f"{new_phase.__name__}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launched, sharded_shapes = phase_distribution(ast, ck, kb)
    adaptive.update(launched)
    time_sharded_k1(ck, sharded_shapes)
    print(f"phase_distribution: {time.perf_counter() - t0:.1f} s")

    launches = {"gj_inverse": narrow, "gj_inverse_wide": wide}
    # the launches of the solves of phases 12 to 20
    more = {"gj_inverse": {k: n for k, (n, _) in adaptive.items()},
            "gj_inverse_wide": {k: n for k, (_, n) in adaptive.items()}}
    source = {"gj_inverse": "asset_asrl_torch/csrc/gj_inverse.cu",
              "gj_inverse_wide": "asset_asrl_torch/csrc/gj_inverse_wide.cu"}

    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    def shapes_of(is_wide):
        return [dict(shape=[K, W, W], **m) for (K, W), m in k1.items()
                if (W > ck.MAX_W) == is_wide]
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source[name],
        replaces="asset_asrl_tpu/Solvers/pallas_kernels.py:103",
        launches=launches[name], launches_from=run,
        launches_elsewhere=more[name], shape=[K, W, W],
        **k1[(K, W)], shapes=shapes_of(W > ck.MAX_W))
        for (K, W), (name, run) in K1_MAIN.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
