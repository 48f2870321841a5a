"""The port's exposition lint against the JAX package's.

``lint()`` reports JAX's violations, message for message, on a corpus
that holds the exposition cases of ``tests/test_observability.py`` (a
clean ``render_prometheus`` body, an orphan sample, a counter not named
``*_total``, an unknown kind, a duplicate TYPE, a bad escape, histograms
out of order, without ``+Inf`` or not cumulative, the gauge typed
counter), more malformations, and real scrapes of the port's registries
(a labeled registry with escapes, the model server's exposition, the
operator families after an Experiment round, a HealthServer).
``lint_url`` reads a live endpoint as JAX's does, and the CLI's
``--self-check --device cpu`` returns 0.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from kubeflow_tpu.observability import lint as jlint  # noqa: E402
from kubeflow_tpu_torch.observability import lint as tlint  # noqa: E402
from kubeflow_tpu_torch.observability.metrics import (  # noqa: E402
    MetricRegistry,
    render_prometheus,
    type_line,
)
from kubeflow_tpu_torch.operators.base import HealthServer  # noqa: E402

_H = type_line("h", "histogram")
CORPUS = {
    "render_prometheus": render_prometheus({"a_total": 1, "b": 2.5}),
    "orphan": "orphan_metric 1\n",
    "counter_name": type_line("bad", "counter") + "bad 1\n",
    "unknown_kind": type_line("x", "chart") + "x 1\n",
    "duplicate": type_line("x_total", "counter") * 2 + "x_total 1\n",
    "escape": type_line("e_total", "counter") + 'e_total{a="b\\q"} 1\n',
    "bucket_order": _H + ('h_bucket{le="1"} 2\nh_bucket{le="0.5"} 1\n'
                          'h_bucket{le="+Inf"} 3\nh_sum 1\nh_count 3\n'),
    "no_inf": _H + 'h_bucket{le="1"} 2\nh_sum 1\nh_count 2\n',
    "not_cumulative": _H + ('h_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
                            'h_sum 1\nh_count 3\n'),
    "gauge_as_counter": (type_line("workqueue_depth", "counter")
                         + "workqueue_depth 4\n"),
    "inf_ne_count": _H + 'h_bucket{le="+Inf"} 3\nh_sum 1\nh_count 4\n',
    "no_sum_count": _H + 'h_bucket{le="+Inf"} 3\n',
    "no_le": _H + 'h_bucket{a="1"} 3\nh_sum 1\nh_count 3\n',
    "bad_le": _H + 'h_bucket{le="x"} 3\nh_sum 1\nh_count 3\n',
    "negative_counter": type_line("n_total", "counter") + "n_total -1\n",
    "gauge_suffix": type_line("g", "gauge") + "g_sum 1\n",
    "malformed_type": "# TYPE lonely\nlonely 1\n",
    "bad_name": type_line("9bad", "gauge") + "9bad 1\n",
    "unquoted": type_line("q", "gauge") + "q{a=b} 1\n",
    "unterminated": type_line("q", "gauge") + 'q{a="b} 1\n',
    "no_value": type_line("q", "gauge") + "q\n",
    "values": (type_line("v", "gauge") + "v +Inf\nv -Inf\nv NaN\n"
               "# HELP v a comment\n\n"),
    "labels_escaped": (type_line("l_total", "counter")
                       + 'l_total{a="x\\"y\\\\z\\n",b="2"} 3\n'),
}


def _registry_body() -> str:
    reg = MetricRegistry()
    reg.counter("demo_requests_total", 'say "hi"', labels=("route",)) \
        .labels('we"ird\\ro\nute').inc(3)
    reg.gauge("demo_depth", "queue depth").set(7)
    reg.histogram("demo_latency_seconds", labels=("kind",)) \
        .labels("admit").observe(0.25)
    return reg.render()


@pytest.mark.parametrize("case", list(CORPUS))
def test_lint_reports_jax_violations(case):
    text = CORPUS[case]
    assert tlint.lint(text) == jlint.lint(text)


def test_lint_of_the_port_registries_and_a_live_endpoint():
    reg_body = _registry_body()
    assert tlint.lint(reg_body) == jlint.lint(reg_body) == []
    reg = MetricRegistry()
    reg.histogram("operator_demo_seconds", labels=("kind",)) \
        .labels("JaxJob").observe(0.01)
    h = HealthServer(0, lambda: {"queue_depth": 4, "adds_total": 9},
                     registries=(reg,))
    h.start()
    try:
        url = f"http://127.0.0.1:{h.port}/metrics"
        assert tlint.lint_url(url) == jlint.lint_url(url) == []
        text = h.render_metrics()
    finally:
        h.stop()
    assert type_line("queue_depth", "gauge") in text
    assert type_line("adds_total", "counter") in text
    # The kernel family a server adds on CUDA lints clean.
    from kubeflow_tpu_torch.serving.server import _kernel_exposition

    kernel_body = _kernel_exposition({"paged_decode_attention": 3,
                                      "rms_norm": 0})
    assert tlint.lint(kernel_body) == jlint.lint(kernel_body) == []
    # A broken body through both, line for line.
    broken = text.replace("_bucket", "_bukket", 1)
    assert tlint.lint(broken) == jlint.lint(broken) != []


def test_self_check_passes_on_cpu(capsys):
    """The CLI's ``main`` with ``--self-check --device cpu``, here."""
    assert tlint.main(["--self-check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "metrics lint ok (model-server (REST + gRPC)" in out
    assert ", gateway, " in out
