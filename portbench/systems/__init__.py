"""Adapters from a configuration's `system` to the port's entry points.

A module here exposes `System(cfg, seed, device)` with `pool` (inputs in
the pool), one method a step a traffic mix may name (`step(request,
record) -> record`: the record the step before returned, None first),
`plain(record)` (what the reference reads of a proof), `free()` and
`check(plains, seed)` (the reference's counts of disagreements, against
the statement built again from the seed). A new kind of statement is a
new module, named by the configurations that use it.
"""
