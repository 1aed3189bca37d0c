"""The benchmark's harness: finds a cell's files by name, drives the
program under test, times the window, traces it and checks its output
against the plain reference."""
