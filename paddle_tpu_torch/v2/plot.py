"""Training-curve plotter, the port of ``paddle_tpu/v2/plot.py`` (reference
python/paddle/v2/plot/plot.py Ploter):
collects (step, value) series per title and renders with matplotlib when
available / in a notebook, else no-op appends — same API either way."""

from __future__ import annotations


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    def __init__(self, *titles):
        self.__args__ = titles
        self.__plot_data__ = {t: PlotData() for t in titles}
        try:  # headless environments: collect only
            import matplotlib  # noqa: F401

            self._has_mpl = True
        except ImportError:
            self._has_mpl = False

    def append(self, title, step, value):
        assert title in self.__plot_data__, f"unknown series {title!r}"
        self.__plot_data__[title].append(step, float(value))

    def plot(self, path=None):
        """Render all series. With `path`, write a PNG there and return the
        path; without, return the matplotlib Figure for the caller to show.
        Never touches the process-global backend."""
        if not self._has_mpl:
            return None
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        fig = Figure()
        ax = fig.add_subplot(111)
        for title in self.__args__:
            d = self.__plot_data__[title]
            ax.plot(d.step, d.value, label=title)
        ax.legend()
        ax.set_xlabel("step")
        if path is not None:
            FigureCanvasAgg(fig)
            fig.savefig(path)
            return path
        return fig

    def reset(self):
        for d in self.__plot_data__.values():
            d.reset()
