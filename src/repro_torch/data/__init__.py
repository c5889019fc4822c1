"""Data utilities of the port: row recovery for selections
(``selection._match_rows``).  The pipeline and selection entry points of
``repro.data`` wait for a later slice."""
