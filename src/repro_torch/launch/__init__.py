"""Launch layer (the counterpart of ``repro.launch``): meshes of stream
slots (``mesh``), the reference's sharding rules over the port's trees
(``sharding``), meta-device shape stand-ins (``specs``) and the train and
serve steps (``steps``). The reference's XLA dry-run tools (``dryrun``,
``hlo_analysis``, ``optflags``, ``reanalyze``) have no counterpart yet."""
