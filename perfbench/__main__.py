import time

T0 = time.perf_counter()  # set-up is timed from here, the harness's first statement

if __name__ == "__main__":
    import sys

    from perfbench.run import main

    sys.exit(main(sys.argv[1:], T0))
