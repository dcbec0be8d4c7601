"""Fixtures of the benchmark's CPU tests."""

import pytest

from pb_helpers import make_checkout


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path)
