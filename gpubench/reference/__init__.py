"""The plain reference that decides a run's ``correct``.

Quasimap's semantics (libgramtools' vBWT backward search, mapping-instance
selection and coverage recording) in plain NumPy, over an FM index, a
coverage graph and a kmer set that this package builds itself from the
PRG. ``markers``, ``linearise``, ``graph``, ``fm``, ``search``,
``coverage`` and ``rng`` are frozen copies of the scalar host oracle
that mirrors the C++ reference line by line; ``jump_table`` and
``kmer_states`` are frozen copies of the numpy kmer-index builder, which
gives every kmer's seed states (the tests hold it to ``search.py``);
``seqs`` builds the suffix array by prefix doubling, and ``quasimap``
maps a reads file. The tests hold the kmer states to a kmer set found
by walking the graph's paths forward (``tests/kmer_paths.py``). Nothing here
imports the measured program.
"""
