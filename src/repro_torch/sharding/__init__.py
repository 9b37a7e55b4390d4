"""Placement of the LM zoo on a data x model ``DeviceMesh``: the port of the
JAX package's ``sharding/`` (:mod:`.rules`, the placement table;
:mod:`.context`, a mesh's axes) plus :mod:`.parallel`, the tensor- and
data-parallel regions the transformer's forward runs through on such a
mesh."""
