"""Tools of the port: the cross-engine oracle (``oracle_lib``) and the
multi-rank dry run (``dryrun``), counterparts of the repo-root
``tools/oracle_lib.py`` and ``__graft_entry__.py``, and measurement tools
for the kernels, which run on a CUDA device."""
