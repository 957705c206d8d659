"""Fault tolerance: the step watchdog, failure injection and the retry loop
(``watchdog``)."""
