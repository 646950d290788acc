"""Sharding of the port: the reference's logical-axis rules and profiles
(:mod:`.specs`, :mod:`.profiles`), the collectives the model code calls on
a mesh (:mod:`.comm`) and the rank's blocks of the parameters, the train
state and the decode cache (:mod:`.layout`)."""
