import os
import sys

# the checkout's root, so that `portbench` and the program import
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
