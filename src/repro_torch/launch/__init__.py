"""Launch layer (the counterpart of ``repro.launch``): meshes of stream
slots (``mesh``), the reference's sharding rules over the port's trees
(``sharding``), meta-device shape stand-ins (``specs``), the train and
serve steps (``steps``), and the dry run: each cell's step run eagerly on
the ``meta`` device (``dryrun``) under a recorder whose op log takes the
place of XLA's HLO and is counted with the reference's rules
(``hlo_analysis``), the reference's ``OptFlags`` (``optflags``), and the
analysis re-derived from saved logs (``reanalyze``)."""
