"""Training callbacks — the port of ``mxtpu/callback.py`` (reference
``python/mxnet/callback.py``).

``Speedometer`` and ``log_train_metric`` feed the port's telemetry
registry with the reference's metric names and help text
(``train_samples_per_s``, ``train_batches_total``, ``train_batch_ms``,
``train_metric{metric}``), and an optional ``summary_writer`` (anything
with ``add_scalar(tag, value, step)``) gets the same scalars. Logging
is the reference's.
"""
from __future__ import annotations

import logging
import time

from . import telemetry

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "log_train_metric",
           "module_checkpoint"]


class Speedometer:
    """Logs samples/sec every ``frequent`` batches (the reference's
    throughput monitor). ``summary_writer`` optionally mirrors speed +
    metrics to TensorBoard; the telemetry registry always gets them."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True, summary_writer=None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.auto_reset = auto_reset
        self.summary_writer = summary_writer
        self._m_speed = telemetry.gauge(
            "train_samples_per_s", "Training throughput (Speedometer)")
        self._m_batches = telemetry.counter(
            "train_batches_total", "Batches processed (Speedometer)")
        self._m_batch_ms = telemetry.histogram(
            "train_batch_ms",
            "Wall time per batch over each Speedometer window — with "
            "train_data_wait_ms and span_train_dispatch_ms this splits "
            "the step: device ≈ wall − data_wait − dispatch")

    def _export(self, speed: float, per_batch_ms: float, name_value,
                step: int) -> None:
        self._m_speed.set(speed)
        self._m_batches.inc(self.frequent)
        self._m_batch_ms.observe(per_batch_ms)
        for name, value in name_value:
            telemetry.gauge("train_metric", "Latest training metric "
                            "value", metric=name).set(value)
        sw = self.summary_writer
        if sw is not None:
            sw.add_scalar("train/samples_per_s", speed, step)
            for name, value in name_value:
                sw.add_scalar(f"train/{name}", value, step)

    def __call__(self, param) -> None:
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                elapsed = time.time() - self.tic
                speed = self.frequent * self.batch_size / elapsed
                name_value = [] if param.eval_metric is None else \
                    param.eval_metric.get_name_value()
                self._export(speed, 1e3 * elapsed / self.frequent,
                             name_value, count)
                if param.eval_metric is not None:
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s"
                    metric_str = "\t".join(f"{n}={v:.6f}"
                                           for n, v in name_value)
                    logging.info(msg, param.epoch, count, speed, metric_str)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    def __init__(self, total: int, length: int = 80):
        self.bar_len = length
        self.total = total

    def __call__(self, param) -> None:
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s", prog_bar, percents, "%")


def do_checkpoint(prefix: str, period: int = 1):
    """Epoch-end callback saving ``prefix-symbol.json`` +
    ``prefix-%04d.params`` (reference ``mx.callback.do_checkpoint``)."""
    from . import model

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period: int, auto_reset: bool = False,
                     summary_writer=None):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                telemetry.gauge("train_metric", "Latest training "
                                "metric value", metric=name).set(value)
                if summary_writer is not None:
                    summary_writer.add_scalar(f"train/{name}", value,
                                              param.nbatch)
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback
