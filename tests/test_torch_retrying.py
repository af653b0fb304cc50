"""``resilience.retrying``, the decorator form of ``retry_call``, against
the JAX package's: under the same injected sequence of failures both
make the same number of attempts, bump the same ``retry.attempts`` /
``retry.exhausted`` counters, name the same retry point (the wrapped
function's ``__qualname__``) and end in the same return or raise;
``functools.wraps`` keeps the wrapped function's name."""
import pytest

from cylon_tpu import faults as jfaults
from cylon_tpu import resilience as jres
from cylon_tpu import trace as jtrace

from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import resilience as tres
from cylon_tpu_torch import trace as ttrace

PKGS = {"jax": (jres, jfaults, jtrace), "port": (tres, tfaults, ttrace)}


@pytest.fixture(autouse=True)
def _counters():
    for _, _, tr in PKGS.values():
        tr.enable_counters()
        tr.reset()
    yield
    for _, _, tr in PKGS.values():
        tr.reset()
        tr.disable_counters()


def _failure(kind, faults):
    if kind == "transient":
        return faults.TransientFault("read.counts", "transient")
    if kind == "connection":
        return ConnectionError("peer reset")
    if kind == "permanent":
        return faults.PermanentFault("read.counts", "permanent")
    return ValueError("not retryable")


def _scenario(pkg, fails, kind, max_attempts, monkeypatch):
    """The decorated function fails ``fails`` times with ``kind`` and then
    returns: (outcome, calls, points, retry counters)."""
    res, faults, tr = PKGS[pkg]
    points = []
    real = res.retry_call

    def spy(fn, *, point="", policy=None):
        points.append(point)
        return real(fn, point=point, policy=policy)

    monkeypatch.setattr(res, "retry_call", spy)
    calls = []
    policy = res.RetryPolicy(max_attempts=max_attempts, base_delay_s=0.0,
                             max_delay_s=0.0, jitter=False)

    @res.retrying(policy)
    def read_counts(x, scale=1):
        """Reads the counts."""
        calls.append(x)
        if len(calls) <= fails:
            raise _failure(kind, faults)
        return x * scale

    try:
        outcome = ("returned", read_counts(7, scale=3))
    except BaseException as e:  # the final raise is part of the result
        outcome = ("raised", type(e).__name__, str(e))
    c = tr.counters()
    return (outcome, len(calls), points,
            (c.get("retry.attempts", 0), c.get("retry.exhausted", 0)),
            read_counts)


@pytest.mark.parametrize("fails,kind,max_attempts", [
    (0, "transient", 3),
    (2, "transient", 3),
    (3, "transient", 3),
    (1, "connection", 2),
    (1, "permanent", 5),
    (1, "other", 5),
], ids=["no-failure", "recovers", "exhausted", "connection-error",
        "permanent", "not-retryable"])
def test_retrying_equals_jax(fails, kind, max_attempts, monkeypatch):
    want = _scenario("jax", fails, kind, max_attempts, monkeypatch)
    got = _scenario("port", fails, kind, max_attempts, monkeypatch)
    assert got[:4] == want[:4]
    outcome, calls, points, counts, _ = got
    assert points == [f"{_scenario.__qualname__}.<locals>.read_counts"]
    if fails < max_attempts and kind in ("transient", "connection"):
        assert outcome == ("returned", 21) and calls == fails + 1
        assert counts == (fails, 0)
    elif kind in ("transient", "connection"):
        assert outcome[0] == "raised" and calls == max_attempts
        assert counts == (max_attempts - 1, 1)
    else:
        assert outcome[0] == "raised" and calls == 1 and counts == (0, 0)


def test_retrying_keeps_the_wrapped_name_and_defaults(monkeypatch):
    *_, fn = _scenario("port", 0, "transient", 1, monkeypatch)
    assert fn.__name__ == "read_counts"
    assert fn.__doc__ == "Reads the counts."
    assert fn.__wrapped__.__qualname__ == fn.__qualname__
    assert "retrying" in tres.__all__
    # no policy: the session policy at call time, as retry_call reads it
    prev = tres.set_retry_policy(tres.RetryPolicy(
        max_attempts=2, base_delay_s=0.0, max_delay_s=0.0, jitter=False))
    try:
        tries = []

        @tres.retrying()
        def flaky():
            tries.append(1)
            raise tfaults.TransientFault("p", "transient")

        with pytest.raises(tfaults.TransientFault):
            flaky()
        assert len(tries) == 2
    finally:
        tres.set_retry_policy(prev)
