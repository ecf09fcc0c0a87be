from .replay import ReplayBuffer, TrajMemory
