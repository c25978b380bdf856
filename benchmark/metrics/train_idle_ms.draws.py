"""ms a training step of device idle under the trainer's ``trainer.draws`` span."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "train", ["trainer.draws"], "train_steps")
