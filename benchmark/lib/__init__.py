"""The harness's own parts: finding a cell's files (`spec`), the traffic
generator (`traffic`), the work the requests needed (`work`), the chip's
peaks and a call's bound (`bounds`), the trace's reading (`trace`) and the
output check (`check`)."""
