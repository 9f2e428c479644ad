"""Entry points of the port (``repro.launch``): ``train``, ``serve`` and
``dryrun``, with the meshes they run on (``mesh``) and the collective
statistics of a traced step (``hlo_stats``)."""
