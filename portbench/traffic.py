"""The one generator of every traffic mix: a mix is a data file of
parameters (``portbench/traffic/<name>.json``), read here.

Keys of a mix:

* ``episode_steps``: time steps in an episode, each episode starting from
  the start state saved at set-up, each step called as the program's
  runner calls it (the deck's constant load);
* ``flow_rate_spread``: the well's flow rate is the deck's times
  ``1 + spread * U(-1, 1)``, drawn from the seed.

Optional keys (their defaults are those of the mixes that leave them
out):

* ``drawn_max``: the seed draws the checked episode among episodes
  1 .. ``drawn_max`` - 1 (default 8);
* ``trace_episodes``: ``[first, last]``, the episodes of a traced run's
  window under the profiler (default ``[drawn_max, drawn_max + 1]``:
  after the drawn one, so that the states kept for the check no longer
  grow the caching allocator, whose calls would read as idle device time).
  A mix of long episodes sets earlier ones, so that a traced run ends in
  time.
"""

from __future__ import annotations

import dataclasses

KEYS = ("episode_steps", "flow_rate_spread")
OPTIONAL = ("drawn_max", "trace_episodes")
DRAWN_MAX = 8


@dataclasses.dataclass(frozen=True)
class Schedule:
    steps: int
    flow_factor: float
    drawn_max: int = DRAWN_MAX
    trace_episodes: tuple = (DRAWN_MAX, DRAWN_MAX + 1)


def schedule(mix: dict, rng) -> Schedule:
    """The episode of ``mix``, its random part drawn from ``rng``."""
    missing = [k for k in KEYS if k not in mix]
    unknown = [k for k in mix if k not in KEYS + OPTIONAL]
    if missing or unknown:
        raise ValueError(f"traffic mix: missing {missing}, unknown "
                         f"{unknown}")
    steps = int(mix["episode_steps"])
    if steps < 1:
        raise ValueError("traffic mix: episode_steps must be >= 1")
    drawn_max = int(mix.get("drawn_max", DRAWN_MAX))
    first, last = (int(e) for e in mix.get("trace_episodes",
                                           (drawn_max, drawn_max + 1)))
    if drawn_max < 2 or not 1 <= first <= last:
        raise ValueError("traffic mix: drawn_max must be >= 2 and "
                         "trace_episodes 1 <= first <= last")
    factor = 1.0 + float(mix["flow_rate_spread"]) * rng.uniform(-1.0, 1.0)
    return Schedule(steps, factor, drawn_max, (first, last))
