"""The process-wide knobs of the port's ``config`` against the JAX
package's: the device memory budget's resolution (explicit setting, then
``CYLON_MEMORY_BUDGET``, then half the device's memory), the plan-cache
capacity (``CYLON_PLAN_CACHE_CAP``) and the optimizer switch
(``CYLON_OPTIMIZER``), with the same validation errors."""
import pytest
import torch

from cylon_tpu import config as jconfig
from cylon_tpu.status import CylonError as JCylonError

from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch.status import CylonError as TCylonError

CPU = torch.device("cpu")


def _budgets():
    return tconfig.device_memory_budget(CPU), jconfig.device_memory_budget()


@pytest.fixture
def unset_budgets():
    tprev = tconfig.set_device_memory_budget(None)
    jprev = jconfig.set_device_memory_budget(None)
    yield
    tconfig.set_device_memory_budget(tprev)
    jconfig.set_device_memory_budget(jprev)


def test_memory_budget_env(monkeypatch, unset_budgets):
    monkeypatch.setenv("CYLON_MEMORY_BUDGET", "12345678")
    assert _budgets() == (12_345_678, 12_345_678)
    # the explicit setting outranks the env var
    tconfig.set_device_memory_budget(1 << 20)
    jconfig.set_device_memory_budget(1 << 20)
    assert _budgets() == (1 << 20, 1 << 20)
    tconfig.set_device_memory_budget(None)
    jconfig.set_device_memory_budget(None)
    for bad in ("0", "-5", "abc", "1.5"):
        monkeypatch.setenv("CYLON_MEMORY_BUDGET", bad)
        with pytest.raises(TCylonError):
            tconfig.device_memory_budget(CPU)
        with pytest.raises(JCylonError):
            jconfig.device_memory_budget()
    monkeypatch.delenv("CYLON_MEMORY_BUDGET")
    half = tconfig.device_memory_budget(CPU)
    assert half > 12_345_678 and half == max(int(
        tconfig.os.sysconf("SC_PAGE_SIZE")
        * tconfig.os.sysconf("SC_PHYS_PAGES") * 0.5), 1 << 20)


@pytest.mark.parametrize("bad", [0, -3, 1.5, True, "64"])
def test_set_memory_budget_validates(bad, unset_budgets):
    with pytest.raises(TCylonError):
        tconfig.set_device_memory_budget(bad)
    with pytest.raises(JCylonError):
        jconfig.set_device_memory_budget(bad)


@pytest.mark.parametrize("pkg,err", [(tconfig, TCylonError),
                                     (jconfig, JCylonError)])
def test_set_plan_cache_capacity_validates(pkg, err):
    for bad in (0, -3, 1.5, True, "64"):
        with pytest.raises(err):
            pkg.set_plan_cache_capacity(bad)
    prev = pkg.set_plan_cache_capacity(7)
    try:
        assert pkg.plan_cache_capacity() == 7
        assert pkg.set_plan_cache_capacity(None) == 7
        assert pkg.plan_cache_capacity() == 128 \
            == pkg.DEFAULT_PLAN_CACHE_CAPACITY
    finally:
        pkg.set_plan_cache_capacity(prev if prev != 7 else None)


@pytest.mark.parametrize("pkg,err", [(tconfig, TCylonError),
                                     (jconfig, JCylonError)])
def test_plan_cache_capacity_env(pkg, err, monkeypatch):
    prev = pkg.set_plan_cache_capacity(None)
    try:
        monkeypatch.setenv("CYLON_PLAN_CACHE_CAP", "3")
        assert pkg.plan_cache_capacity() == 3
        for bad in ("0", "many"):
            monkeypatch.setenv("CYLON_PLAN_CACHE_CAP", bad)
            with pytest.raises(err):
                pkg.plan_cache_capacity()
        # the explicit knob outranks the env var
        pkg.set_plan_cache_capacity(5)
        assert pkg.plan_cache_capacity() == 5
    finally:
        pkg.set_plan_cache_capacity(prev)


@pytest.mark.parametrize("pkg,err", [(tconfig, TCylonError),
                                     (jconfig, JCylonError)])
def test_optimizer_switch(pkg, err, monkeypatch):
    with pytest.raises(err):
        pkg.set_optimizer_enabled(1)  # not a bool
    prev = pkg.set_optimizer_enabled(None)
    try:
        for value, on in (("0", False), ("", False), ("1", True),
                          ("yes", True)):
            monkeypatch.setenv("CYLON_OPTIMIZER", value)
            assert pkg.optimizer_enabled() is on
        monkeypatch.delenv("CYLON_OPTIMIZER")
        assert pkg.optimizer_enabled()
        assert pkg.set_optimizer_enabled(False) is None
        assert not pkg.optimizer_enabled()
    finally:
        pkg.set_optimizer_enabled(prev)


@pytest.fixture
def unset_host_budgets():
    tprev = tconfig.set_host_memory_budget(None)
    jprev = jconfig.set_host_memory_budget(None)
    yield
    tconfig.set_host_memory_budget(tprev)
    jconfig.set_host_memory_budget(jprev)


def test_host_memory_budget_matches_jax(monkeypatch, unset_host_budgets):
    """The host-tier (spill) budget: explicit setting, then
    ``CYLON_HOST_MEMORY_BUDGET``, then half the physical RAM (at least
    64 MiB), with the same validation, in both packages."""
    monkeypatch.delenv("CYLON_HOST_MEMORY_BUDGET", raising=False)
    auto = tconfig.host_memory_budget()
    assert auto == jconfig.host_memory_budget() >= 64 << 20
    monkeypatch.setenv("CYLON_HOST_MEMORY_BUDGET", "98765432")
    assert tconfig.host_memory_budget() == jconfig.host_memory_budget() \
        == 98_765_432
    assert tconfig.set_host_memory_budget(1 << 20) is None
    jconfig.set_host_memory_budget(1 << 20)
    assert tconfig.host_memory_budget() == jconfig.host_memory_budget() \
        == 1 << 20
    assert tconfig.set_host_memory_budget(None) == 1 << 20
    jconfig.set_host_memory_budget(None)
    for bad in ("0", "-5", "abc", "1.5"):
        monkeypatch.setenv("CYLON_HOST_MEMORY_BUDGET", bad)
        with pytest.raises(TCylonError):
            tconfig.host_memory_budget()
        with pytest.raises(JCylonError):
            jconfig.host_memory_budget()
    for bad in (0, -3, 1.5, True, "64"):
        with pytest.raises(TCylonError):
            tconfig.set_host_memory_budget(bad)
        with pytest.raises(JCylonError):
            jconfig.set_host_memory_budget(bad)
    monkeypatch.delenv("CYLON_HOST_MEMORY_BUDGET")
    assert tconfig.host_memory_budget() == auto


@pytest.mark.parametrize("pkg,err", [(tconfig, TCylonError),
                                     (jconfig, JCylonError)])
def test_spill_switch(pkg, err, monkeypatch):
    with pytest.raises(err):
        pkg.set_spill_enabled(1)  # not a bool
    prev = pkg.set_spill_enabled(None)
    try:
        for value, on in (("0", False), ("", False), ("1", True),
                          ("yes", True)):
            monkeypatch.setenv("CYLON_SPILL", value)
            assert pkg.spill_enabled() is on
        monkeypatch.delenv("CYLON_SPILL")
        assert pkg.spill_enabled()
        assert pkg.set_spill_enabled(False) is None
        assert not pkg.spill_enabled()
    finally:
        pkg.set_spill_enabled(prev)
