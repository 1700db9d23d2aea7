"""What a metric's reader is given: the run's record, with the sums the
readers share."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass
class Context:
    cell: object
    record: dict
    quantile: Callable[[List[float], float], float]

    # ---------------------------------------------------------- the window
    @property
    def times(self) -> List[float]:
        """Seconds of each solve of the window, from its call until its x
        is on the device."""
        return self.record["times"]

    @property
    def iterations(self) -> int:
        """CGLS iterations of the solves completed in the window."""
        return int(sum(self.record["iters"]))

    @property
    def window_s(self) -> float:
        """From the window's start to the end of its last solve."""
        return self.record["t_end"] - self.record["t_start"]

    @property
    def setup_s(self) -> float:
        return self.record["setup_s"]

    # ----------------------------------------------------------- the trace
    @property
    def trace(self) -> Optional[dict]:
        """The trace summary (:mod:`.trace`), where one was read."""
        return self.record["trace"] or None

    @property
    def traced_iters(self) -> int:
        return int(self.record.get("traced_iters", 0))

    def roofline_pct(self, range_name: str) -> Optional[float]:
        """The bound time of every call of the range over the device time
        of the kernels launched inside it, in %; ``None`` where the range
        ran no device work."""
        st = (self.trace or {}).get("ranges", {}).get(range_name)
        bound = self.record["bounds"].get(range_name, 0.0)
        if not st or st["device_s"] <= 0.0 or bound <= 0.0:
            return None
        return 100.0 * st["calls"] * bound / st["device_s"]
