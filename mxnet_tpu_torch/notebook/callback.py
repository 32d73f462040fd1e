"""Training-statistics loggers and live learning-curve plotting for
notebooks (port of ``mxnet_tpu/notebook/callback.py``; reference
python/mxnet/notebook/callback.py).  pandas, matplotlib and IPython are
imported when a logger or chart is made, not at import.

``PandasLogger`` keeps the reference's API and dataframe layout (train /
eval / epoch frames, ``callback_args()`` to wire all three callbacks into
``Module.fit``).  The live chart uses matplotlib instead of the
reference's bokeh (matplotlib is the kernel-agnostic choice; bokeh is
not in this image) — ``LiveLearningCurve`` redraws in-place inside
Jupyter and degrades to saving a PNG outside it.
"""
from __future__ import annotations

import datetime
import time


def _add_new_columns(dataframe, metrics):
    """Add new metrics as new columns to selected pandas dataframe
    (reference callback.py:_add_new_columns)."""
    new_columns = set(metrics.keys()) - set(dataframe.columns)
    for col in new_columns:
        dataframe[col] = None


class PandasLogger(object):
    """Logs training statistics into pandas dataframes: ``train_df``
    (every ``frequent`` minibatches), ``eval_df`` (once per epoch over the
    eval set), ``epoch_df`` (epoch wall-clock).  Reference
    notebook/callback.py:PandasLogger."""

    def __init__(self, batch_size, frequent=50):
        try:
            import pandas as pd
        except ImportError:
            raise ImportError("PandasLogger needs pandas")
        self.batch_size = batch_size
        self.frequent = frequent
        self._dataframes = {
            "train": pd.DataFrame(),
            "eval": pd.DataFrame(),
            "epoch": pd.DataFrame(),
        }
        self.last_time = time.time()
        self.start_time = datetime.datetime.now()
        self.last_epoch_time = datetime.datetime.now()

    @property
    def train_df(self):
        return self._dataframes["train"]

    @property
    def eval_df(self):
        return self._dataframes["eval"]

    @property
    def epoch_df(self):
        return self._dataframes["epoch"]

    @property
    def all_dataframes(self):
        return self._dataframes

    def elapsed(self):
        return datetime.datetime.now() - self.start_time

    def append_metrics(self, metrics, df_name):
        dataframe = self._dataframes[df_name]
        _add_new_columns(dataframe, metrics)
        dataframe.loc[len(dataframe)] = metrics

    def train_cb(self, param):
        if param.nbatch % self.frequent == 0:
            self._process_batch(param, "train")

    def eval_cb(self, param):
        self._process_batch(param, "eval")

    def _process_batch(self, param, dataframe):
        now = time.time()
        if param.eval_metric is not None:
            metrics = dict(param.eval_metric.get_name_value())
        else:
            metrics = {}
        speed = self.frequent / max(now - self.last_time, 1e-9)
        metrics["batches_per_sec"] = speed
        metrics["records_per_sec"] = speed * self.batch_size
        metrics["elapsed"] = self.elapsed()
        metrics["minibatch_count"] = param.nbatch
        metrics["epoch"] = param.epoch
        self.append_metrics(metrics, dataframe)
        self.last_time = now

    def epoch_cb(self):
        metrics = {}
        metrics["elapsed"] = self.elapsed()
        now = datetime.datetime.now()
        metrics["epoch_time"] = now - self.last_epoch_time
        self.append_metrics(metrics, "epoch")
        self.last_epoch_time = now

    def callback_args(self):
        """kwargs for ``Module.fit`` wiring all three callbacks:
        ``model.fit(train, eval_data=val, **logger.callback_args())``."""
        return {
            "batch_end_callback": self.train_cb,
            "eval_end_callback": self.eval_cb,
            "epoch_end_callback": lambda *a, **kw: self.epoch_cb(),
        }


class LiveLearningCurve(object):
    """Live-updating learning curve of a metric from a PandasLogger
    (reference LiveBokehChart/LiveLearningCurve, matplotlib edition).

    In a Jupyter kernel the figure redraws in place every
    ``display_freq`` seconds; headless, ``savefig(path)`` renders the
    final curve to a PNG."""

    def __init__(self, pandas_logger, metric_name, display_freq=5):
        self.pandas_logger = pandas_logger
        self.metric_name = metric_name
        self.display_freq = display_freq
        self.last_update = time.time()
        self._fig = None

    def _setup(self):
        import matplotlib
        import matplotlib.pyplot as plt
        self._plt = plt
        self._in_ipython = matplotlib.get_backend().lower() \
            .endswith(("nbagg", "ipympl", "inline"))
        self._fig, self._ax = plt.subplots(figsize=(6, 4))

    def _draw(self):
        if self._fig is None:
            self._setup()
        ax = self._ax
        ax.clear()
        # common x-axis: elapsed wall-clock — train rows (every `frequent`
        # batches) and eval rows (once per epoch) land on one timeline
        for df_name, style in (("train", "-"), ("eval", "--")):
            df = self.pandas_logger.all_dataframes[df_name]
            if self.metric_name in getattr(df, "columns", []):
                xs = [td.total_seconds() for td in df["elapsed"]]
                ax.plot(xs, df[self.metric_name].astype(float).values,
                        style, label=df_name)
        ax.set_xlabel("elapsed (s)")
        ax.set_ylabel(self.metric_name)
        ax.legend(loc="best")
        ax.grid(True, alpha=0.3)
        if getattr(self, "_in_ipython", False):  # pragma: no cover
            from IPython import display
            display.clear_output(wait=True)
            display.display(self._fig)

    def batch_cb(self, param):
        self.pandas_logger.train_cb(param)
        if time.time() - self.last_update > self.display_freq:
            self._draw()
            self.last_update = time.time()

    def eval_cb(self, param):
        self.pandas_logger.eval_cb(param)
        self._draw()

    def savefig(self, path):
        """Render the current curve to ``path`` (PNG)."""
        self._draw()
        self._fig.savefig(path, dpi=100, bbox_inches="tight")

    def callback_args(self):
        return {
            "batch_end_callback": self.batch_cb,
            "eval_end_callback": self.eval_cb,
            "epoch_end_callback":
                lambda *a, **kw: self.pandas_logger.epoch_cb(),
        }
