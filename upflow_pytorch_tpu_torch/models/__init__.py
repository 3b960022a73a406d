"""The networks (UPFlow, RAFT, GMFlow) and their serving entry
(``entry``)."""
