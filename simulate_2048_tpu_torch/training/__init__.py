"""Training stack: config, losses, replay, self-play, learner, checkpoint, trainer.

Import the submodules directly (``from simulate_2048_tpu_torch.training.trainer
import Trainer``); nothing is imported here, so that ``training.config`` stays
importable from the model modules without a cycle.
"""
