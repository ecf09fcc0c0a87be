from .dynamics import (rk4_step, DynState, SingleIntegrator, DoubleIntegrator,
                       DoubleIntegratorSpeed, DoubleIntegratorRoll, make_dynamics)
from .barrier import BarrierFunction, NoBarrier, TiltBarrierFunction, setup_barrier
from .policies import RollPolicy, ZeroPolicy, BarrierPushPolicy, LQRPolicy, make_policy
from .klerg import KlergConfig, KlergPlanner, PlannerState
from .target_dists import (GaussianMixtureDist, gaussian_dist, prior_dist, UniformDist,
                           ExplrDist)
from .baselines import BaselineController, BaselineDraws, BaselineState
