from .renderer import TrayScene, render_camera
from .env import SyntheticEnv, EnvState
