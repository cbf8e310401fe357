"""The suite's collection: every test is collected once, from the file
that defines it.

A test module that imports a `test_*` function from another would have
it collected twice; a test moved between files must not be left in
both. Imports no JAX.
"""

import collections


def test_no_test_is_collected_twice(request):
    items = request.session.items
    twice = [nid for nid, n in collections.Counter(i.nodeid for i in items).items() if n > 1]
    assert not twice
    # A test function is collected only from the module that defines it.
    strays = [i.nodeid for i in items if hasattr(i, "function") and i.function.__module__ != i.module.__name__]
    assert not strays
