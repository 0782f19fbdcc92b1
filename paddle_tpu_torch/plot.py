"""Training-curve plotting (reference: python/paddle/v2/plot/ Ploter; a
copy of ``paddle_tpu/plot.py``).

Collects (step, value) series per cost name; renders with matplotlib when
it is installed, else prints a text sparkline, so a headless run works."""

from __future__ import annotations

from typing import Dict, List

__all__ = ["Ploter"]

_BLOCKS = "▁▂▃▄▅▆▇█"


class Ploter:
    def __init__(self, *titles: str):
        self.titles = list(titles)
        self.data: Dict[str, List[tuple]] = {t: [] for t in titles}

    def append(self, title: str, step: int, value: float) -> None:
        if title not in self.data:
            raise ValueError(f"unknown series {title!r}; declared "
                             f"{self.titles}")
        self.data[title].append((step, float(value)))

    def _spark(self, values: List[float]) -> str:
        if not values:
            return ""
        lo, hi = min(values), max(values)
        span = (hi - lo) or 1.0
        return "".join(_BLOCKS[int((v - lo) / span * (len(_BLOCKS) - 1))]
                       for v in values)

    def plot(self, path: str = None) -> None:
        """Render to `path` (png via matplotlib) or print sparklines.
        Only a missing matplotlib falls back; render/IO errors raise."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            for t in self.titles:
                vals = [v for _, v in self.data[t]]
                last = f"{vals[-1]:.4f}" if vals else "-"
                print(f"{t:>24} {self._spark(vals[-60:])} {last}")
            return
        fig, ax = plt.subplots()
        for t in self.titles:
            if self.data[t]:
                xs, ys = zip(*self.data[t])
                ax.plot(xs, ys, label=t)
        ax.legend()
        ax.set_xlabel("step")
        fig.savefig(path or "plot.png")
        plt.close(fig)

    def reset(self) -> None:
        for t in self.titles:
            self.data[t] = []
