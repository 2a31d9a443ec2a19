"""Phases: what a traffic mix's ``phase`` names. A phase file gives the
loop the window drives (``Loop``), the networks it trains (``NETS``), the
calls of one iteration for the operation counts (``calls``), the plain
reference's run of it (``reference_run``) and the check of the program's
iterations against it (``numbers``). A new kind of work adds a file here."""
