"""Launch-side tools of the port: HLO ingestion (``hlo_analysis``,
``comm_graph``) and the mesh's device order (``mesh``)."""
