/* feed_c — a C rank that feeds a job of port ranks (the native path's
 * MPMD job: `zmpirun -n 1 feed_c ROWS ROW_LEN : -n P prog.py`).
 *
 * Rank 0 is this program, ranks 1..P are port ranks
 * (zhpe_ompi_tpu_torch.host_init()).  Each row is ROW_LEN int64 words
 * (a sequence's tokens, then its targets).
 *
 *   1. MPI_Recv the ROWS x ROW_LEN rows from rank 1 (tag 23).
 *   2. MPI_Scatterv them: ROWS / P rows to each port rank, 0 to itself.
 *   3. MPI_Gatherv one float32 per row back (each row's cross-entropy,
 *      computed by the port ranks on the card).
 *   4. MPI_Bcast the mean (one double) to every rank.
 *   5. MPI_Barrier, print one `FEED {json}` line, MPI_Finalize.
 *
 * The port ranks take their side of steps 2-4 on the shim's collective
 * wire (see zhpe_ompi_tpu_torch/native/cwire.py).
 *
 * Build: python -m zhpe_ompi_tpu_torch.tools.zmpicc feed_c.c -o feed_c
 */
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>

#include "zompi_mpi.h"

int main(int argc, char **argv) {
  int rank, size;
  if (MPI_Init(&argc, &argv) != MPI_SUCCESS) return 2;
  MPI_Comm_rank(MPI_COMM_WORLD, &rank);
  MPI_Comm_size(MPI_COMM_WORLD, &size);
  if (argc != 3 || rank != 0 || size < 2) {
    fprintf(stderr, "feed_c: usage ROWS ROW_LEN, as rank 0 of >= 2\n");
    MPI_Abort(MPI_COMM_WORLD, 3);
  }
  const int rows = atoi(argv[1]), row_len = atoi(argv[2]);
  const int ports = size - 1;
  if (rows <= 0 || row_len <= 0 || rows % ports != 0) {
    fprintf(stderr, "feed_c: %d rows do not split over %d ranks\n", rows,
            ports);
    MPI_Abort(MPI_COMM_WORLD, 4);
  }
  const int per = rows / ports;
  int64_t *data = malloc(sizeof(int64_t) * (size_t)rows * row_len);
  float *ce = malloc(sizeof(float) * (size_t)rows);
  int *counts = malloc(sizeof(int) * size);
  int *displs = malloc(sizeof(int) * size);
  MPI_Status st;
  int got;
  if (MPI_Recv(data, rows * row_len, MPI_INT64_T, 1, 23, MPI_COMM_WORLD,
               &st) != MPI_SUCCESS)
    return 5;
  MPI_Get_count(&st, MPI_INT64_T, &got);
  if (got != rows * row_len) {
    fprintf(stderr, "feed_c: %d words, want %d\n", got, rows * row_len);
    return 6;
  }
  /* deal the rows: none to this rank, `per` to each port rank */
  counts[0] = displs[0] = 0;
  for (int r = 1; r < size; r++) {
    counts[r] = per * row_len;
    displs[r] = (r - 1) * per * row_len;
  }
  int64_t none;
  if (MPI_Scatterv(data, counts, displs, MPI_INT64_T, &none, 0, MPI_INT64_T,
                   0, MPI_COMM_WORLD) != MPI_SUCCESS)
    return 7;
  /* each row's cross-entropy back, in rank order */
  for (int r = 1; r < size; r++) {
    counts[r] = per;
    displs[r] = (r - 1) * per;
  }
  float nothing = 0.0f;
  if (MPI_Gatherv(&nothing, 0, MPI_FLOAT, ce, counts, displs, MPI_FLOAT, 0,
                  MPI_COMM_WORLD) != MPI_SUCCESS)
    return 8;
  double mean = 0.0;
  for (int i = 0; i < rows; i++) mean += ce[i];
  mean /= rows;
  if (MPI_Bcast(&mean, 1, MPI_DOUBLE, 0, MPI_COMM_WORLD) != MPI_SUCCESS)
    return 9;
  MPI_Barrier(MPI_COMM_WORLD);
  printf("FEED {\"rank\": %d, \"size\": %d, \"rows\": %d, \"mean_ce\": %.17g, "
         "\"row_ce\": [", rank, size, rows, mean);
  for (int i = 0; i < rows; i++) printf(i ? ", %.9g" : "%.9g", ce[i]);
  printf("]}\n");
  fflush(stdout);
  free(data);
  free(ce);
  free(counts);
  free(displs);
  MPI_Finalize();
  return 0;
}
