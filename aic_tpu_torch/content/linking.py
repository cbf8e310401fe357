"""BlockProvider: typed installation of named block sets into a universe.

Copied unchanged from `aic_tpu/content/linking.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX.

Role of the reference's linking module (all-is-cubes/src/linking.rs:96
`BlockProvider<E>` with `install()` at :204 and `using()` at :235):
content modules define a named set of blocks once; installing them
registers each as a universe `BlockDef` and returns a provider whose
blocks are `Indirect` references to those definitions, so later
redefinition (BlockDef.redefine) updates every placement. `using()`
re-links against an existing universe and reports missing names rather
than silently substituting.

Keys are strings (the Python analog of the reference's exhaustible enum
keys); names in the universe are namespaced "module/key" exactly like
`name_in_module`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

from ..block import Block, BlockDef, Indirect


class ProviderError(KeyError):
    """linking.rs ProviderError: missing definitions, all named."""

    def __init__(self, missing: list[str]):
        super().__init__(f"missing block definitions: {', '.join(missing)}")
        self.missing = tuple(missing)


class BlockProvider:
    """A typed mapping key → Block (linking.rs:96 Provider)."""

    def __init__(self, module: str, mapping: Mapping[str, Block]):
        self.module = module
        self._map = dict(mapping)

    @staticmethod
    def new(module: str, definer: Callable[[str], Block], keys: Iterable[str]) -> "BlockProvider":
        """Provider::new_sync: build each key's block from `definer`."""
        return BlockProvider(module, {k: definer(k) for k in keys})

    def __getitem__(self, key: str) -> Block:
        return self._map[key]

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def keys(self):
        return self._map.keys()

    def name_of(self, key: str) -> str:
        """linking.rs name_in_module."""
        return f"{self.module}/{key}"

    def install(self, universe) -> "BlockProvider":
        """Register every block as a universe BlockDef and return a new
        provider of Indirect blocks referring to them (linking.rs:204)."""
        out = {}
        for key, blk in self._map.items():
            name = self.name_of(key)
            existing = universe.block_defs.get(name)
            if existing is None:
                bd = BlockDef(blk)
                universe.block_defs[name] = bd
            else:
                bd = existing
                bd.redefine(blk)
            out[key] = Block(Indirect(block_def=bd))
        return BlockProvider(self.module, out)

    @staticmethod
    def using(universe, module: str, keys: Iterable[str]) -> "BlockProvider":
        """Re-link against definitions already installed in `universe`;
        raises ProviderError naming every missing key (linking.rs:235)."""
        found, missing = {}, []
        for key in keys:
            name = f"{module}/{key}"
            bd = universe.block_defs.get(name)
            if bd is None:
                missing.append(name)
            else:
                found[key] = Block(Indirect(block_def=bd))
        if missing:
            raise ProviderError(missing)
        return BlockProvider(module, found)
