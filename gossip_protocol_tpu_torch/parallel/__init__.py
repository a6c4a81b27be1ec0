"""Multi-device execution on a mesh of one process (port of
``gossip_protocol_tpu/parallel/``): the mesh and its collectives
(``mesh.py``), the dense tick's comms (``comm.py``), peer-sharded runs
(``sharded.py``) and meshes of fleets (``fleet_mesh.py``)."""
