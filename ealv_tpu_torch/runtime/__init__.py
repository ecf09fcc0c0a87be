from .agent import Experiment, ExperimentState, PostTrainDraws, TickDraws
from .tester import EvalExperiment, EvalState
from .evaluate import evaluate_test_set, imagined_views, eval_report
from .trainer import TrainerStatics, TrainDraws, train_call
from .schedules import HyperState, entropy_grade, entropy_grade_spread, hyperparam_update
from .host_loop import HostLoopRunner
