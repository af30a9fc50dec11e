"""The training run of the port: ``Trainer`` (steps, evaluation, the epoch
loop), its optimizer, schedule, callbacks and checkpoints."""
