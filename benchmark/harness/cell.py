"""One cell as a driver sees it: its configuration, traffic and limits, the
run's seed and device, and the sub-seeds every input is drawn from."""

from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from . import files


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object  # torch.device
    marks: list = field(default_factory=list)  # (set-up part, time.time() at its end)

    @classmethod
    def load(cls, name: str, seed: int, device, bench: str = files.BENCH) -> "Cell":
        spec = files.workload(name, bench)
        return cls(name=name, config=files.config(spec["config"], bench),
                   traffic=files.traffic(spec["traffic"], bench), limits=spec["limits"],
                   seed=seed, device=device)

    def mark(self, part: str) -> None:
        """End the set-up part ``part`` now."""
        self.marks.append((part, time.time()))

    def seed_for(self, tag: str) -> int:
        """A seed under 2**63 for the input named ``tag``, from the run's seed."""
        ss = np.random.SeedSequence([self.seed % 2**64, zlib.crc32(tag.encode())])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def rng(self, tag: str) -> np.random.Generator:
        return np.random.default_rng(self.seed_for(tag))

    def staged_weights(self) -> dict:
        """The configuration's staged EMA weights (the flax tree of numpy
        arrays), read from the file with the benchmark's own reader."""
        from benchmark.reference.msgpack_reader import read_checkpoint

        return read_checkpoint(os.path.join(files.ROOT, self.config["weights"]))["ema_params"]
