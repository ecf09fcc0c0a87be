"""The program's entries that traffic drives, one module an entry, named
as a traffic file's ``entry``; each defines ``Entry``, a
``drive.Driver``."""
