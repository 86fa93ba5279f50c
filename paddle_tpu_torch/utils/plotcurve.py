"""Plot training curves from trainer logs, the port of
``paddle_tpu/utils/plotcurve.py`` (reference
python/paddle/utils/plotcurve.py:74 plot_paddle_curve): extract
`Pass=N ... <Key>=V` rows from a log stream and plot/save them.
matplotlib is imported inside ``plot_paddle_curve``."""

from __future__ import annotations

import re
import sys

__all__ = ["extract_curve", "plot_paddle_curve"]


def extract_curve(keys, inputfile):
    """Parse `Pass=.. Key=..` train rows and `Test samples=..` eval rows;
    returns (train ndarray [N, 1+len(keys)], test ndarray)."""
    import numpy as np

    pass_pattern = r"Pass=([0-9]*)"
    test_pattern = r"Test samples=([0-9]*)"
    keys = list(keys) or ["AvgCost"]
    for k in keys:
        pass_pattern += r".*?%s=([0-9e\-\.]*)" % k
        test_pattern += r".*?%s=([0-9e\-\.]*)" % k
    cp, ct = re.compile(pass_pattern), re.compile(test_pattern)
    data, test_data = [], []
    for line in inputfile:
        m = cp.search(line)
        if m:
            data.append([float(x) for x in m.groups()])
        m = ct.search(line)
        if m:
            test_data.append([float(x) for x in m.groups()])
    return np.array(data), np.array(test_data)


def plot_paddle_curve(keys, inputfile, outputfile, format="png",
                      show_fig=False):
    """reference plotcurve.py:74 — same signature; matplotlib optional
    (headless environments still get the parsed curves back)."""
    keys = list(keys) or ["AvgCost"]
    x, x_test = extract_curve(keys, inputfile)
    if x.shape[0] <= 0:
        sys.stderr.write("No data to plot. Exiting!\n")
        return x, x_test
    try:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot
    except ImportError:
        return x, x_test
    for i, k in enumerate(keys, start=1):
        pyplot.plot(x[:, 0], x[:, i], label=k)
        if x_test.shape[0] > 0 and x_test.shape[1] > i:
            pyplot.plot(x_test[:, 0], x_test[:, i], label="Test " + k)
    pyplot.xlabel("Pass")
    pyplot.legend(loc="best")
    pyplot.savefig(outputfile, format=format)
    if show_fig:
        pyplot.show()
    pyplot.close()
    return x, x_test
