"""The staged feed: ``pairs`` distinct batch pairs in the uint8 wire
format, made from the seed on the card once (:func:`inputs.fundus_batches`)
and cycled, so the step decodes on the card as in training and the loader
is bypassed. Traffic keys: ``pairs``."""

from __future__ import annotations

from benchmark.harness import inputs


class Feed:
    def __init__(self, traffic: dict, config: dict, seed: int, device):
        data = config["program"]["data"]
        self.batches = inputs.fundus_batches(seed, int(traffic["pairs"]),
                                             int(data["batch_size"]), int(data["image_size"]),
                                             device)
        self.i = 0

    def replay_key(self) -> int:
        """What :meth:`replay` needs to give the next pull's batch again."""
        return self.i % len(self.batches)

    def replay(self, key: int) -> dict:
        return self.batches[key]

    def take(self) -> dict:
        batch = self.batches[self.i % len(self.batches)]
        self.i += 1
        return batch

    def put(self, batch: dict) -> dict:
        return batch  # already on the card

    def close(self) -> None:
        pass
