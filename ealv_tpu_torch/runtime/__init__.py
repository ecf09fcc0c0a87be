from .agent import Experiment, ExperimentState, PostTrainDraws, TickDraws
from .trainer import TrainerStatics, TrainDraws, train_call
from .schedules import HyperState, entropy_grade, entropy_grade_spread, hyperparam_update
