"""The one generator of every traffic mix: a mix is a data file of
parameters (``portbench/traffic/<name>.json``), read here.

Keys of a mix:

* ``episode_steps``: time steps in an episode, each episode starting from
  the start state saved at set-up, each step called as the program's
  runner calls it (the deck's constant load);
* ``flow_rate_spread``: the well's flow rate is the deck's times
  ``1 + spread * U(-1, 1)``, drawn from the seed.
"""

from __future__ import annotations

import dataclasses

KEYS = ("episode_steps", "flow_rate_spread")


@dataclasses.dataclass(frozen=True)
class Schedule:
    steps: int
    flow_factor: float


def schedule(mix: dict, rng) -> Schedule:
    """The episode of ``mix``, its random part drawn from ``rng``."""
    missing = [k for k in KEYS if k not in mix]
    unknown = [k for k in mix if k not in KEYS]
    if missing or unknown:
        raise ValueError(f"traffic mix: missing {missing}, unknown "
                         f"{unknown}")
    steps = int(mix["episode_steps"])
    if steps < 1:
        raise ValueError("traffic mix: episode_steps must be >= 1")
    factor = 1.0 + float(mix["flow_rate_spread"]) * rng.uniform(-1.0, 1.0)
    return Schedule(steps, factor)
