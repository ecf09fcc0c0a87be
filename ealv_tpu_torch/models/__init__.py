from .cvae import CVAE, ModelState, init_model_state, update_dist
from .losses import gaussian_nll, kl_divergence, cvae_loss
